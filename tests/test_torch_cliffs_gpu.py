"""The dispatch cliffs and the engine fuzz on the card: every case of
``dwarf_bench_tpu_torch/utils/cliffs.py`` (the counterparts of
``tests/test_cliffs_slow.py`` and ``tests/test_engine_fuzz.py``) at the JAX
files' own sizes on CUDA tensors, held to the host oracles (``np.sort``,
``filter_oracle``'s rows, the join's probe, ``id_buffer`` and flags), each
taking the branch the host predicts and launching that branch's kernels
(``_build.LAUNCHES``: chunk_stats, cumsum, scan_tail_streams and
compact_mask, emit_prefix or filter for the scan; histogram and cumsum for
the counting sort; histogram for the join's build). They skip without a
card. Like ``tests/test_torch_gpu.py`` this file imports no JAX:

    python -m pytest tests/test_torch_cliffs_gpu.py -m gpu --noconftest -q

``tests/test_torch_cliffs.py`` holds the same cases against the JAX package
on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")

from dwarf_bench_tpu_torch.utils import cliffs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.parametrize("name", [c.name for c in cliffs.CASES])
def test_cliff_case_on_the_card(cuda, name):
    got = cliffs.run(cliffs.BY_NAME[name], cuda)
    assert got.ok, got.line()
    assert got.ms is not None and got.ms > 0
    kernels = cliffs.BRANCH_KERNELS[f"{cliffs.BY_NAME[name].engine}:"
                                    f"{got.branch}"]
    assert all(got.launched.get(k, 0) > 0 for k in kernels), got.line()
    if got.branch == "torch.sort":
        assert "histogram" not in got.launched, got.line()
