"""The port's breakdown tools patch a copy of a kernel source, compiling
parts of the kernel out under macros; each switched text must still occur
in the source as many times as the tool expects, or the tool would time
the wrong build.  CPU only: the patched sources are built on the card."""
import pytest

from paddle_tpu_torch import _cuda
from paddle_tpu_torch.tools import (ffn_chain_breakdown, flash_breakdown,
                                    gemm_breakdown, paged_split_variants)


@pytest.mark.parametrize("tool,source", [
    (ffn_chain_breakdown, "gemm_epilogue"),
    (flash_breakdown, "flash_attention"),
    (gemm_breakdown, "gemm_epilogue"),
])
def test_breakdown_switches_match_the_source(tool, source):
    # the float32 entries' source with its kernel header inlined: what
    # the tool patches and builds
    text = _cuda.source_text(source)
    assert "#include \"" + source + ".cuh\"" not in text
    patched = tool.patched_source(text)
    for macros in tool.VARIANTS.values():
        for macro in macros:
            assert f"#ifdef {macro}" in patched or f"#ifndef {macro}" in patched
    assert patched != text


def _switch_defaults(text):
    return dict(line.split()[1:3] for line in text.splitlines()
                if line.startswith("#define PAGED_SPLIT_"))


def test_paged_split_switches_match_the_header():
    """The serving kernels' variant tool sets only build switches that the
    shared header defines, and each build changes at least one kernel's
    default (a source may set its own before including the header)."""
    header = (_cuda.CSRC / "paged_split.cuh").read_text()
    defaults = {}
    for src in paged_split_variants.SOURCES:
        text = (_cuda.CSRC / f"{src}.cu").read_text()
        assert '#include "paged_split.cuh"' in text
        defaults[src] = {**_switch_defaults(header), **_switch_defaults(
            text.split('#include "paged_split.cuh"')[0])}
    for name, switches in paged_split_variants.BUILDS.items():
        changed = 0
        for switch in switches:
            macro, value = switch.split("=")
            assert f"#ifndef {macro}\n#define {macro} " in header
            changed += any(d[macro] != value for d in defaults.values())
        assert changed or name == "as_is", name
    assert not set(paged_split_variants.SPANS) & \
        set(paged_split_variants.BUILDS)
