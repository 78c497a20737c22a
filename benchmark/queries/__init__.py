"""Query kinds: how a cell calls the program and judges its outputs."""
