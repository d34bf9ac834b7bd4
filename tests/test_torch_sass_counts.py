"""`utils/sass_counts.py` reads a cuobjdump -sass listing and a ptxas log
(on the CPU, on text shaped as the CUDA 12 tools print it): the
instructions of each function, predicated ones included, and each entry
function's register and spill report."""

import pytest

from admm_elastic_tpu_torch.utils import sass_counts

LISTING = """
	code for sm_90a
		Function : _ZN4admm4step13update_kernelIfEEvPKT_
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.WIDE R2, R0, 0x4, R2 ;   /* 0x0000000400027825 */
        /*0020*/              @!P0 LDG.E R4, desc[UR4][R2.64] ;   /* 0x00000004 */
        /*0030*/                   FADD R5, R4, R4 ;   /* 0x00000004 */
        /*0040*/                   UCGABAR_ARV ;   /* 0x00000004 */
        /*0050*/                   EXIT ;   /* 0x000000000000794d */
		..........
		Function : _ZN4admm6banded13vertex_kernelIdLi0EEEvNS0_4ArgsIT_EE
        /*0000*/                   DADD R4, R2, R4 ;   /* 0x00000004 */
        /*0010*/                   STG.E.64 desc[UR4][R2.64], R4 ;   /* 0x0 */
"""

LOG = """== cg_step.cu
ptxas info    : Compiling entry function '_ZN4admm4step13update_kernelIfEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN4admm4step13update_kernelIfEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 264 bytes smem
"""


def test_listing_is_read_by_function():
    fns = sass_counts.functions(LISTING)
    upd, vtx = fns
    assert fns[upd] == ["LDC", "IMAD.WIDE", "LDG.E", "FADD", "UCGABAR_ARV",
                        "EXIT"]
    assert fns[vtx] == ["DADD", "STG.E.64"]


@pytest.mark.parametrize("op,kind", [
    ("FFMA", "float"), ("DADD", "float"), ("MUFU.RSQ", "float"),
    ("LDG.E.64", "memory"), ("STS", "memory"), ("IMAD.WIDE.U32", "wide"),
    ("IADD3.X", "wide"), ("LEA.HI.X", "wide"), ("UCGABAR_WAIT", "barrier"),
    ("BAR.SYNC.DEFER_BLOCKING", "barrier"), ("IMAD", "other"),
    ("ISETP.GE.AND", "other")])
def test_opcode_classes(op, kind):
    assert sass_counts._classify(op) == kind


def test_ptxas_report_by_entry():
    got = sass_counts.ptxas_lines(LOG)
    line = got["_ZN4admm4step13update_kernelIfEEvPKT_"]
    assert line.startswith("0 bytes stack frame, 0 bytes spill stores")
    assert "Used 40 registers" in line
