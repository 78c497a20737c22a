"""Bytes a ``filter`` query needs, whatever implements it: each input byte
read once and each kept row written once."""


def bytes_needed(args, kept_rows: int) -> int:
    (x,) = args
    return (x.numel() + kept_rows) * x.element_size()
