"""tests/torch_sass_wgmma.py, the check of in-flight wgmma registers, on
small hand-written SASS in cuobjdump's form: it passes the pattern the
q8 prefill kernel's mainloop compiles to (fragments double-buffered, one
group in flight) and flags each breach, on a straight path and across a
loop's back edge. The card test
test_torch_cuda.py::test_q8_prefill_sass_keeps_in_flight_wgmma_registers
runs it on the built kernels."""

import pytest

from torch_sass_wgmma import functions, hazards, loop_mix

# a double-buffered mainloop: group A (R156, R128, R132, R136) in flight
# while group B's fragments (R140-R155) are rebuilt, and back, with the
# accumulators R24-R127 read only after the last wait
LOOP = [
    "LDSM.16.MT88.4 R156, [R6]",
    "LDSM.16.MT88.4 R128, [R6+0x1000]",
    "LDSM.16.MT88.4 R132, [R6+0x2000]",
    "LDSM.16.MT88.4 R136, [R6+0x3000]",
    "CS2R R24, SRZ",
    # loop top (0x0050)
    "WARPGROUP.ARRIVE",
    "HGMMA.64x208x16.F32.BF16 R24, R156, gdesc[UR16], R24",
    "HGMMA.64x208x16.F32.BF16 R24, R128, gdesc[UR16], R24",
    "HGMMA.64x208x16.F32.BF16 R24, R132, gdesc[UR16], R24",
    "HGMMA.64x208x16.F32.BF16 R24, R136, gdesc[UR16], R24, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "LDSM.16.MT88.4 R12, [R6]",
    "PRMT R140, R12, R7, 0x43434343",
    "HADD2.BF16_V2 R141, R13, -R14",
    "LOP3.LUT R144, R15, 0xff7fff7f, RZ, 0xc0, !PT",
    "MOV R148, R12",
    "IMAD.U32 R152, RZ, RZ, UR10",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x208x16.F32.BF16 R24, R140, gdesc[UR16], R24",
    "HGMMA.64x208x16.F32.BF16 R24, R144, gdesc[UR16], R24",
    "HGMMA.64x208x16.F32.BF16 R24, R148, gdesc[UR16], R24",
    "HGMMA.64x208x16.F32.BF16 R24, R152, gdesc[UR8], R24, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "LDSM.16.MT88.4 R156, [R6+0x800]",
    "MOV R128, R12",
    "PRMT R132, R12, R7, 0x43434343",
    "LOP3.LUT R136, R15, 0xff7fff7f, RZ, 0xc0, !PT",
    "ISETP.NE.AND P0, PT, R5, R2, PT",
    "@P0 BRA 0x50",
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",
    "FMUL R5, R24, R3",
    "STS.64 [R4], R26",
    "EXIT",
]


def sass(lines):
    body = "\n".join(f"        /*{16 * i:04x}*/                   {ln} ;"
                     for i, ln in enumerate(lines))
    return f"\t\tFunction : kernel\n{body}\n"


def check(lines):
    return hazards(functions(sass(lines))["kernel"])


def edited(at, line):
    """LOOP with the instruction at index ``at`` replaced."""
    return LOOP[:at] + [line] + LOOP[at + 1:]


def test_the_double_buffered_mainloop_passes():
    assert check(LOOP) == []


@pytest.mark.parametrize("at,line,regs,what", [
    # the open group's own fragment, before its commit
    (8, "MOV R157, RZ", [157], "writes R{}, an in-flight wgmma's A fragment"),
    # the group still in flight after the wait that keeps one
    (12, "PRMT R129, R12, R7, 0x43434343", [129],
     "writes R{}, an in-flight wgmma's A fragment"),
    # the accumulators, read or written before the last wait
    (13, "FMUL R5, R24, R3", [24],
     "reads R{}, an in-flight wgmma's accumulator"),
    (27, "STS.64 [R4], R126", [126, 127],
     "reads R{}, an in-flight wgmma's accumulator"),
    (27, "MOV R30, RZ", [30], "writes R{}, an in-flight wgmma's accumulator"),
])
def test_each_breach_is_flagged(at, line, regs, what):
    found = check(edited(at, line))
    assert len(found) == len(regs), found
    for f, r in zip(found, regs):
        assert what.format(r) in f, found


def test_a_breach_reached_only_over_the_back_edge_is_flagged():
    """Group B (R140-R155) is in flight at the loop's top only when the
    loop comes round again: a write to it before the first wait there."""
    lines = LOOP[:5] + ["WARPGROUP.ARRIVE", "MOV R144, RZ"] + LOOP[6:]
    lines[-5] = "@P0 BRA 0x50"
    found = check(lines)
    assert len(found) == 1 and "writes R144" in found[0], found
    # on the first pass alone (the branch removed) nothing is in flight
    lines[-5] = "NOP"
    assert check(lines) == []


def test_a_wait_retires_all_but_the_groups_it_keeps():
    """DEPBAR.LE 1 keeps the newest group: rebuilding it is a breach,
    rebuilding the one before it is not; LE 0 retires both."""
    assert check(edited(11, "MOV R140, RZ")) == []
    found = check(edited(11, "MOV R136, RZ"))
    assert len(found) == 1 and "R136" in found[0]
    assert check(edited(10, "WARPGROUP.DEPBAR.LE gsb0, 0x0")
                 [:11] + ["MOV R136, RZ"] + LOOP[12:]) == []


def test_control_flow_it_cannot_follow_is_refused():
    found = check(LOOP[:-1] + ["CALL.REL.NOINC 0x0"])
    assert found and "does not follow" in found[0]
    found = check(edited(28, "@P0 BRA 0x7770"))
    assert found and "does not find" in found[0]


# the flash forward's overlapped tile (csrc/flash.cu): S of the next tile
# (shared-memory operands, accumulators R24-R87) and P·V of this one (P
# from registers R88-R95, O in R120-R151) issued as two groups; the wait
# that keeps one retires S, the softmax rewrites S in place while P·V is
# in flight; the last wait retires P·V, then O is rescaled and the next
# P packed into P's registers
FLASH = [
    "WARPGROUP.ARRIVE",
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT",
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R120, R88, gdesc[UR12], R120",
    "HGMMA.64x64x16.F32.BF16 R120, R92, gdesc[UR16], R120, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "FMNMX R4, R24, R25, !PT",
    "FFMA R24, R24, R3, -R5",
    "MUFU.EX2 R24, R24",
    "FADD R6, R24, R6",
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",
    "FMUL R120, R120, R7",
    "F2FP.BF16.F32.PACK_AB R88, R25, R24",
    "EXIT",
]


def test_the_overlapped_flash_tile_passes():
    assert check(FLASH) == []


@pytest.mark.parametrize("at,line,reg,what", [
    # the next P packed into P's registers while P·V still reads them
    (10, "F2FP.BF16.F32.PACK_AB R90, R25, R24", 90,
     "writes R{}, an in-flight wgmma's A fragment"),
    # O rescaled while P·V still accumulates into it
    (10, "FMUL R121, R121, R7", 121,
     "writes R{}, an in-flight wgmma's accumulator"),
    # the softmax run before the wait that retires S
    (6, "FFMA R30, R30, R3, -R5", 30,
     "writes R{}, an in-flight wgmma's accumulator"),
])
def test_a_write_to_an_in_flight_flash_product_is_flagged(at, line, reg,
                                                         what):
    lines = FLASH[:at] + [line] + FLASH[at:]
    found = check(lines)
    assert found and what.format(reg) in found[0], found


# the one-pass flash backward's step (csrc/flash_bwd.cu, opk): Sᵀ
# (R24-R55) and dPᵀ (R56-R87) issued as two groups; the wait that keeps
# one retires Sᵀ, Pᵀ is packed into R88-R91 and dV += Pᵀ·dO (dV in
# R120-R151) issued; the next wait that keeps one retires dPᵀ while dV
# is in flight, dSᵀ is formed in dPᵀ's registers, packed into R92-R95 and
# stored for dQ, dK += dSᵀ·Q (dK in R152-R183) issued; after the
# warpgroups' barrier dQ (64 × 32 in R184-R199) is issued from shared
# memory, and the last wait retires dV, dK and dQ before dQ is staged
ONE_PASS = [
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT",
    "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R56, gdesc[UR12], RZ, !UPT",
    "HGMMA.64x64x16.F32.BF16 R56, gdesc[UR16], R56, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "FFMA R24, R24, R3, -R5",
    "MUFU.EX2 R24, R24",
    "F2FP.BF16.F32.PACK_AB R88, R25, R24",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R120, R88, gdesc[UR20], R120, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "FFMA R6, R56, R7, -R8",
    "FMUL R56, R24, R6",
    "F2FP.BF16.F32.PACK_AB R92, R57, R56",
    "STS [R9], R92",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R152, R92, gdesc[UR24], R152, gsb0",
    "BAR.SYNC.DEFER_BLOCKING 0x1, 0x100",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x32x16.F32.BF16 R184, gdesc[UR28], RZ, !UPT",
    "HGMMA.64x32x16.F32.BF16 R184, gdesc[UR32], R184, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",
    "STS.128 [R10], R184",
    "EXIT",
]


def test_the_one_pass_backward_step_passes():
    assert check(ONE_PASS) == []


@pytest.mark.parametrize("at,line,reg,what", [
    # dSᵀ packed into Pᵀ's registers while dV += Pᵀ·dO still reads them
    (13, "F2FP.BF16.F32.PACK_AB R89, R57, R56", 89,
     "writes R{}, an in-flight wgmma's A fragment"),
    # dSᵀ's registers rewritten while dK += dSᵀ·Q still reads them
    (19, "MOV R93, RZ", 93,
     "writes R{}, an in-flight wgmma's A fragment"),
    # dSᵀ formed before the wait that retires dPᵀ
    (12, "FMUL R57, R25, R6", 57,
     "writes R{}, an in-flight wgmma's accumulator"),
    # dQ staged before the last wait
    (23, "STS.128 [R10], R184", 184,
     "reads R{}, an in-flight wgmma's accumulator"),
])
def test_a_write_to_an_in_flight_one_pass_product_is_flagged(at, line, reg,
                                                            what):
    lines = ONE_PASS[:at] + [line] + ONE_PASS[at:]
    found = check(lines)
    assert found and what.format(reg) in found[0], found


# a tile loop inside an outer loop: the column test (two instructions a
# branch skips) left out of the count, four exponentials a pass
MIX = [
    "MOV R2, RZ",
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",
    "@P1 BRA 0x60",
    "ISETP.GE.AND P2, PT, R7, R8, PT",
    "FSEL R24, R24, -INF, P2",
    "FFMA R24, R24, R3, -R5",
    "MUFU.EX2 R24, R24",
    "MUFU.EX2 R25, R25",
    "MUFU.EX2 R26, R26",
    "MUFU.EX2 R27, R27",
    "F2FP.BF16.F32.PACK_AB R88, R25, R24",
    "IADD3 R9, R9, 0x1, RZ",
    "ISETP.NE.AND P0, PT, R9, R10, PT",
    "@P0 BRA 0x10",
    "@P3 BRA 0x0",
    "EXIT",
]


def test_loop_mix_counts_the_tile_loop_by_pipe():
    insts = functions(sass(MIX))["kernel"]
    assert loop_mix(insts, 4) == {"mufu": 1.0, "fp32": 0.25,
                                  "integer": 0.5, "conversion": 0.25,
                                  "move": 0.0, "tensor": 0.25,
                                  "other": 0.75}
    assert loop_mix(insts, 5) is None
