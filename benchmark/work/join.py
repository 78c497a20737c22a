"""Bytes a ``join`` query needs, whatever implements it: each build key
and each probe key read once (4 bytes each), ``id_buffer`` written once
(4 bytes a build row), and each probe row's view written once (found,
pos and counts: 9 bytes a probe row). That is 8 bytes a build row and 13
a probe row."""


def bytes_needed(args, written: int) -> int:
    build, probe = args
    return (2 * build.numel() * build.element_size()
            + probe.numel() * probe.element_size() + 9 * written)
