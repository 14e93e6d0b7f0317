"""The SASS instruction census (``repro_torch.kernels.sass``) that counts
K1's instructions an element, on small hand-written listings in
``cuobjdump -sass`` form: the hot path of a vector loop, with slow paths
(a subroutine call, local memory, float64) left out."""
import pytest
import torch

from repro_torch.kernels import sass

torch.set_num_threads(2)              # six xdist workers share the CPUs


def _listing(name, rows):
    lines = ["\tcode for sm_90a", f"\t\tFunction : {name}",
             '\t.headerflags\t@"EF_CUDA_SM90"']
    for addr, text in rows:
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     "                 /* 0x000fe20000000a00 */")
        lines.append("                                              "
                     "                   /* 0x000fe20000000a00 */")
    return "\n".join(lines) + "\n"


LOOP = _listing("_Z4loopPf", [
    (0x00, "LDC R1, c[0x0][0x28]"),
    (0x10, "S2R R0, SR_TID.X"),
    (0x20, "LDG.E.128 R4, desc[UR4][R2.64]"),
    (0x30, "FFMA R4, R4, R5, R6"),
    (0x40, "FSETP.GEU.AND P0, PT, R4, 1, PT"),
    (0x50, "@!P0 BRA 0x90"),
    (0x60, "STL [R1], R4"),               # slow path, branched around
    (0x70, "DMUL R8, R8, R10"),
    (0x80, "BRA 0x90"),
    (0x90, "MUFU.RSQ R7, R4"),
    (0xa0, "I2FP.F32.U32 R8, R0"),
    (0xb0, "STG.E.128 desc[UR4][R2.64], R4"),
    (0xc0, "ISETP.NE.AND P1, PT, R0, R9, PT"),
    (0xd0, "@P1 BRA 0x20"),
    (0xe0, "EXIT"),
    (0xf0, "BRA 0xf0"),
    (0x100, "NOP"),
])

# One guarded block per element and no loop: nothing to count.
UNROLLED = _listing("_Z8unrolledPt", [
    (0x00, "S2R R0, SR_TID.X"),
    (0x10, "@P0 BRA 0x60"),               # guard of element 1
    (0x20, "FMUL R3, R3, 2"),
    (0x30, "STG.E.U16 desc[UR4][R4.64], R3"),
    (0x40, "HFMA2.MMA R5, -RZ, RZ, 0, 0"),
    (0x50, "BSSY B0, 0x60"),
    (0x60, "BSYNC B0"),                   # element 2 starts at this join
    (0x70, "IADD3 R2, R2, 0x100, RZ"),
    (0x80, "@P0 BRA 0xd0"),               # guard of element 2
    (0x90, "FFMA R3, R3, R4, R5"),
    (0xa0, "@!P1 BRA 0xc0"),
    (0xb0, "CALL.REL.NOINC 0x200"),       # sqrt's slow path
    (0xc0, "STG.E.U16 desc[UR4][R4.64], R3"),
    (0xd0, "BSYNC B0"),
    (0xe0, "EXIT"),
])


def test_census_vector_loop():
    res = sass.census(LOOP, "loop", 4)
    assert res["per_element"] == 9 / 4
    assert res["by_pipe"] == {"fp32": 2 / 4, "conversion": 1 / 4,
                              "mufu": 1 / 4, "memory": 2 / 4,
                              "branch": 2 / 4, "integer": 1 / 4}
    assert res["static"] == 16                 # NOP not counted


def test_census_needs_a_vector_loop():
    with pytest.raises(ValueError, match="no vector loop"):
        sass.census(UNROLLED, "unrolled", 1)


def test_census_needs_one_function_and_elements():
    both = LOOP + UNROLLED
    with pytest.raises(ValueError):
        sass.census(both, "_Z", 4)
    with pytest.raises(ValueError):
        sass.census(both, "loop", 0)           # no elements per iteration
    assert sass.census(both, "loop", 4)["per_element"] == 9 / 4


@pytest.mark.parametrize("op,pipe", [
    ("FFMA", "fp32"), ("I2FP.F32.U32", "conversion"), ("F2I.NTZ", "conversion"),
    ("MUFU.RSQ", "mufu"), ("HMMA.16816.F32.BF16", "tensor"),
    ("LDGSTS.E.BYPASS.128", "memory"), ("LDSM.16.MT88.4", "memory"),
    ("LOP3.LUT", "integer"), ("ULDC.64", "uniform"), ("BSSY", "branch"),
    ("HFMA2.MMA", "other")])
def test_pipe_classes(op, pipe):
    assert sass.pipe(op) == pipe


def test_count_ops():
    text = _listing("_Z5flashv", [(0x0, "HMMA.16816.F32.BF16 R4, R8, R12, R4"),
                                 (0x10, "HMMA.16816.F32.BF16 R4, R8, R14, R4"),
                                 (0x20, "EXIT")])
    assert sass.count_ops(text, "flash", "HMMA") == 2
