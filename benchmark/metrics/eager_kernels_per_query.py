"""``eager_kernels_per_query``: kernels and memsets a traced query whose
launching runtime call lies outside every ``kernel.*`` span of the port:
the eager torch ops' kernels, which ``_build.LAUNCHES`` does not count
(``benchmark/spans.py``). With the wrappers' kernels they make
``kernels_per_query``."""

from benchmark import spans


def read(run):
    sp = spans.of_run(run)
    return None if sp is None else spans.eager_kernels_per_query(sp)
