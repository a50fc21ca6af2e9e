"""The port's profiler on the card: a ``state="GPU"`` session records the
CUDA kernels, and a kernel launched inside an ``observability`` span lies
inside that span's range of the Kineto trace.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips on a host without a card.  On a machine with one (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_trace.py

(On the CPU, ``tests/test_torch_observability.py`` holds that "GPU" and
"All" raise without a card, and reads a synthetic trace back.)  The
span runs the kernel and a synchronisation, so its device side holds
the kernel.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import _cuda
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.generation.ragged_attention import (
    ragged_paged_attention, ragged_ref_attention)
from paddle_tpu_torch.observability import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no "
                    "CPU mode (the trace readers are tested on the CPU)")
    return torch.device("cuda")


def _ragged_case(device, num_heads=12, head_dim=64, page_size=16,
                 pages_per_seq=8, rows=8):
    rng = np.random.RandomState(0)
    H = num_heads * head_dim
    num_pages = rows * pages_per_seq + 1
    k, v = (torch.from_numpy(rng.randn(num_pages, page_size, H).astype(
        np.float32)).to(device) for _ in range(2))
    q = torch.from_numpy(rng.randn(rows, H).astype(np.float32)).to(device)
    tables = torch.from_numpy(np.arange(1, num_pages).reshape(
        rows, pages_per_seq).astype(np.int32)).to(device)
    lens = torch.from_numpy(rng.randint(1, page_size * pages_per_seq,
                                        rows).astype(np.int32)).to(device)
    return q, k, v, tables, lens, num_heads


@pytest.mark.parametrize("state", ["GPU", "All"])
def test_kernel_launch_lies_inside_its_span(device, state, tmp_path):
    args = _ragged_case(device)
    want = ragged_ref_attention(*args)
    ragged_paged_attention(*args)          # build and load outside
    torch.cuda.synchronize()
    before = _cuda.LAUNCHES["ragged_paged_attention"]
    prof.reset_profiler()
    prof.start_profiler(state, tracer_path=str(tmp_path))
    try:
        with tracing.span("test:attention") as ctx:
            got = ragged_paged_attention(*args)
            torch.cuda.synchronize()
        ragged_paged_attention(*args)          # outside any span
        torch.cuda.synchronize()
    finally:
        prof.stop_profiler(quiet=True)
    assert ctx is not None
    assert _cuda.LAUNCHES["ragged_paged_attention"] == before + 2
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    doc = prof.load_device_trace()
    assert prof.last_device_trace().startswith(str(tmp_path))
    n, inside = prof.kernels_inside(doc, "ragged_attention_kernel",
                                    "test:attention")
    assert (n, inside) == (2, 1)
    assert len(prof.trace_ranges(doc, "test:attention")) == 1
    assert len(prof.trace_ranges(doc, "test:attention", device=True)) == 1
    # the host event of the span carries its ids
    (event,) = [e for e in prof._events if e[0] == "test:attention"]
    assert event[4]["span_id"] == ctx.span_id


def test_cuda_profiler_runs_the_cuda_activity(device, tmp_path):
    args = _ragged_case(device)
    ragged_paged_attention(*args)
    with prof.cuda_profiler(str(tmp_path)):
        ragged_paged_attention(*args)
        torch.cuda.synchronize()
    kernels = prof.trace_kernels(prof.load_device_trace())
    assert any("ragged_attention_kernel" in name for name, _, _ in kernels)
