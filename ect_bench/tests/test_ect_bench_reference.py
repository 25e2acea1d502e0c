"""The plain reference against frames the port writes on the CPU (its plain
versions), at small sizes: it accepts them, and rejects a frame with one
payload bit flipped and a frame written at another table log. The tests
import the port; the reference does not."""

import subprocess
import sys

import numpy as np
import pytest

import entropy_coders_tpu_torch.frame as F
from ect_bench import data
from ect_bench.reference import Knobs, check_frame, parse
from ect_bench.reference import fse

TEXT = data.text(5 * 32768 + 1234, 42)
SEQ = data.gen_sequence(0.2, 6 * 32768, 42)

CASES = {
    "lanes_fast": (TEXT, dict(block_size=32768, k=256,
                              table_log=["fast", 0.0025])),
    "lanes_int": (SEQ, dict(block_size=32768, k=128, table_log=8)),
    "shared": (TEXT, dict(block_size=32768, k=256, table_log=["fast", 0.0025],
                          shared_table=True)),
    "stream_k": (TEXT, dict(block_size=32768, k=256, table_log=9,
                            lanes=False)),
    "stream_k2": (TEXT[:70000], dict(block_size=16384, k=2, table_log="auto",
                                     lanes=False)),
    "packed_crc": (SEQ, dict(block_size=32768, k=256, table_log="auto",
                             bit_pack=True, checksum=True)),
    "short_tail": (TEXT[: 32768 + 7], dict(block_size=32768, k=256,
                                           table_log=8)),
    "one_block": (TEXT[:1000], dict(block_size=32768, k=128, table_log=8)),
}


def frame_of(x, kw):
    port = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    port.setdefault("lanes", True)
    return F.compress(x, device="cpu", **port)


def knobs_of(kw):
    return Knobs(kw["block_size"], kw["k"], kw["table_log"],
                 kw.get("lanes", True), kw.get("shared_table", False),
                 kw.get("checksum", False), kw.get("bit_pack", False))


@pytest.mark.parametrize("case", sorted(CASES))
def test_accepts_the_ports_frames(case):
    x, kw = CASES[case]
    rep = check_frame(frame_of(x, kw), x, knobs_of(kw))
    assert rep.wrong == 0, (rep.frame_wrong, rep.blocks_wrong)
    assert rep.blocks_checked == -(-len(x) // kw["block_size"])


def test_modes_rle_and_raw_blocks():
    x = SEQ.copy()
    x[32768: 2 * 32768] = 7  # a constant block: RLE
    rng = np.random.default_rng(1)
    x[3 * 32768: 4 * 32768] = rng.integers(0, 256, 32768)  # RAW
    kw = dict(block_size=32768, k=128, table_log=8)
    fr = frame_of(x, kw)
    assert list(parse(fr).modes[:4]) == [3, 2, 3, 1]
    assert check_frame(fr, x, knobs_of(kw)).wrong == 0


@pytest.mark.parametrize("case", ["lanes_fast", "stream_k", "shared"])
def test_rejects_a_flipped_payload_bit(case):
    x, kw = CASES[case]
    fr = bytearray(frame_of(x, kw))
    pf = parse(bytes(fr))
    # a bit in the middle of block 1's section, past its headers
    at = int(pf.offs[1] + pf.lens[1] * 2 // 3)
    fr[at] ^= 0x10
    rep = check_frame(bytes(fr), x, knobs_of(kw))
    assert [i for i, _ in rep.blocks_wrong] == [1]


def test_rejects_a_frame_at_another_table_log():
    x, kw = CASES["lanes_int"]
    other = dict(kw, table_log=7)
    rep = check_frame(frame_of(x, other), x, knobs_of(kw))
    assert rep.wrong == len(rep.blocks_wrong) == 6
    assert all("table" in why or "entry" in why for _, why in rep.blocks_wrong)


def test_rejects_a_frame_of_other_bytes_and_a_truncated_frame():
    x, kw = CASES["lanes_fast"]
    fr = frame_of(x, kw)
    y = x.copy()
    y[100] ^= 1
    assert check_frame(fr, y, knobs_of(kw)).blocks_wrong
    assert check_frame(fr[:-1], x, knobs_of(kw)).frame_wrong


def test_a_sample_of_blocks():
    x, kw = CASES["lanes_fast"]
    rep = check_frame(frame_of(x, kw), x, knobs_of(kw), blocks=[0, 5])
    assert rep.blocks_checked == 2 and rep.wrong == 0


def test_header_round_trip_and_policy_tables():
    counts = np.bincount(TEXT, minlength=256)
    for policy in (5, 9, 15, "auto", "fast", ["fast", 0.015]):
        tab, l2 = fse.policy_table(counts, len(TEXT), policy)
        assert int(np.abs(tab).sum()) == 1 << l2
        got, l2b, n = fse.read_header(fse.write_header(tab, l2) + b"rest")
        assert l2b == l2 and np.array_equal(got, tab)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import ect_bench.reference, ect_bench.data; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('entropy_coders_tpu', 'entropy_coders_tpu_torch', 'jax', "
            "'torch')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
