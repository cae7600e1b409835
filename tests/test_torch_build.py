"""The port's kernel build helper: what it does without a compiler.

The SASS reader is plain text processing, so it is held here against a
listing in ``cuobjdump -sass`` format; the build itself needs nvcc and runs
on the machine with the card (``chip_smoke.py``).
"""
import pytest

from diffusion_extensions_tpu_torch.ops import _build

_LISTING = """
Fatbin elf code:
================
arch = sm_90a
	code for sm_90a
		Function : _ZN4tile4sumsEPKfxS1_xxPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
                                                                                 /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                            /* 0x0000000000007919 */
        /*0020*/                   LDS.128 R4, [R2] ;                            /* 0x0000000002047984 */
        /*0030*/                   FFMA R5, R4, R4, R5 ;                         /* 0x0000000404057223 */
        /*0040*/                   FMUL R5, R5, R6 ;                             /* 0x0000000605057220 */
        /*0050*/                   MUFU.RCP R6, R5 ;                             /* 0x0000000500067308 */
        /*0060*/                   MUFU.EX2 R5, R5 ;                             /* 0x0000000500057308 */
        /*0070*/                   MUFU.EX2 R7, R7 ;                             /* 0x0000000700077308 */
        /*0080*/              @!P0 BRA 0x20 ;                                    /* 0xfffffff800e88947 */
        /*0090*/                   FADD R5, R5, R7 ;                             /* 0x0000000705057221 */
        /*00a0*/               @P1 BRA 0x90 ;                                    /* 0xfffffffc00fc1947 */
        /*00b0*/                   EXIT ;                                        /* 0x000000000000794d */
        /*00c0*/                   BRA 0xc0;                                     /* 0xfffffffc00fc7947 */
		Function : flat
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   MUFU.LG2 R0, R0 ;                             /* 0x0000000000007308 */
        /*0010*/              @P0  BRA 0x30 ;                                    /* 0x0000000000047947 */
        /*0020*/                   FADD R0, R0, R0 ;                             /* 0x0000000000007221 */
        /*0030*/                   EXIT ;                                        /* 0x000000000000794d */
"""


def test_parse_sass_counts_functions_and_hottest_loop():
    out = _build.parse_sass(_LISTING)
    assert set(out) == {"_ZN4tile4sumsEPKfxS1_xxPf", "flat"}
    tile = out["_ZN4tile4sumsEPKfxS1_xxPf"]
    assert (tile["instructions"], tile["mufu"], tile["fp32"], tile["shared_loads"]) == (13, 3, 3, 1)
    # the loop 0x20..0x80 holds the MUFU work, not the one-add loop 0x90..0xa0
    assert tile["loop"] == {"instructions": 7, "mufu": 3, "fp32": 2, "shared_loads": 1,
                            "ex2": 2}
    # a forward branch is no loop
    assert out["flat"]["loop"] is None and out["flat"]["mufu"] == 1


def test_parse_sass_takes_the_innermost_loop():
    """An outer loop holds the inner loop's MUFU work and more; the inner
    one is the one counted."""
    listing = """
		Function : nested
        /*0000*/                   MOV R0, RZ ;
        /*0010*/                   LDS R1, [R0] ;
        /*0020*/                   MUFU.EX2 R2, R1 ;
        /*0030*/                   FFMA R3, R2, R2, R3 ;
        /*0040*/              @P0  BRA 0x20 ;
        /*0050*/                   MUFU.EX2 R4, R3 ;
        /*0060*/              @P1  BRA 0x10 ;
        /*0070*/                   EXIT ;
"""
    out = _build.parse_sass(listing)["nested"]
    assert out["mufu"] == 2 and out["instructions"] == 8
    assert out["loop"] == {"instructions": 3, "mufu": 1, "fp32": 1, "shared_loads": 0, "ex2": 1}


def test_parse_sass_of_nothing_is_empty():
    assert _build.parse_sass("") == {}
    assert _build.parse_sass("no listing here\n") == {}


def test_sass_summary_without_a_library_or_the_tool_is_none(tmp_path, monkeypatch):
    assert _build.sass_summary(None) is None
    monkeypatch.setattr(_build, "_cuda_tool", lambda name: None)
    assert _build.sass_summary(tmp_path / "libnone.so") is None


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "_cuda_tool", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(_build.CSRC / "gaussian_kernel_sum.cu", ("-DNOT_BUILT_HERE",))
