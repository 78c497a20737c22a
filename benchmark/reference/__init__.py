"""Plain references of the query kinds; they import nothing of the program."""
