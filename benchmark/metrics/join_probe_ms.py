"""``join_probe_ms``: the device ms a traced query spends in the kernels
and memsets launched from inside the port's ``probe_dense`` spans (the
dense CSR join's lookups), read as ``join_build_ms`` reads ``build_dense``.
It reads nothing where no such span launched anything."""

from benchmark import spec

SPAN = "probe_dense"


def read(run):
    return spec.metric_reader("join_build_ms").device_ms(run, SPAN)
