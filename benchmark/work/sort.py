"""Bytes a ``sort`` query needs, whatever implements it: each input byte
read once and each output byte written once (the output is as large as the
input)."""


def bytes_needed(args, written=0) -> int:
    (x,) = args
    return 2 * x.numel() * x.element_size()
