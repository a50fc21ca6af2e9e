"""The port's breakdown tools patch a copy of a kernel source, compiling
parts of the kernel out under macros; each switched text must still occur
in the source as many times as the tool expects, or the tool would time
the wrong build.  CPU only: the patched sources are built on the card."""
import pytest

from paddle_tpu_torch import _cuda
from paddle_tpu_torch.tools import (ffn_chain_breakdown, flash_breakdown,
                                    gemm_breakdown)


@pytest.mark.parametrize("tool,source", [
    (ffn_chain_breakdown, "gemm_epilogue.cu"),
    (flash_breakdown, "flash_attention.cu"),
    (gemm_breakdown, "gemm_epilogue.cu"),
])
def test_breakdown_switches_match_the_source(tool, source):
    text = (_cuda.CSRC / source).read_text()
    patched = tool.patched_source(text)
    for macros in tool.VARIANTS.values():
        for macro in macros:
            assert f"#ifdef {macro}" in patched or f"#ifndef {macro}" in patched
    assert patched != text
