"""tests/torch_sass_wgmma.py, the check of in-flight wgmma registers, on
small hand-written SASS in cuobjdump's form: it passes the pattern the
q8 prefill kernel's mainloop compiles to (fragments double-buffered, one
group in flight) and flags each breach, on a straight path and across a
loop's back edge. The card test
test_torch_cuda.py::test_q8_prefill_sass_keeps_in_flight_wgmma_registers
runs it on the built kernels."""

import pytest

from torch_sass_wgmma import functions, hazards

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
