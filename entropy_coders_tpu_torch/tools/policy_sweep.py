"""The table-log policy sweep of the per-lane path, on the card.

Counterpart of the root ``policy_sweep.py``, with its sets: for each config
(the bench shape, 16 MiB blocks at k=16384, and the library default, 128
KiB blocks at k=1024), B1's decode rate at each fixed table log L in 8..11
on the geo corpus (``bench_configs.device_decode_gbps``); then, for each
policy and corpus, the ratio, the per-block chosen-L counts and the
effective decode rate, total bytes over sum(block bytes / rate at the
block's L), a log outside 8..11 taking L=11's rate. That formula assumes,
as the JAX script does, that B1's time depends on (R, L, k) and not on the
payload: config 6 of ``bench_configs`` times B1 at the throughput point
(L=8, or 9 where a block's symbols reach 255) on every corpus, which tests
it on the card.

Policies: fixed 10, ``"auto"`` (the reference's per-block optimal log),
``("fast", eps)`` for eps in {0.25%, 0.5%, 1%}; ``("fast", 0.0025)`` is the
container's default (``frame.PL_TABLE_LOG``), which this sweep records and
does not change. Corpora, 32 MiB each: geo (the bench distribution), text,
bf16 and jsonlog, shared with ``bench_configs`` through its ``Corpora``.
Every compress passes ``lanes=True``; every round trip is checked exact.
Prints one JSON line per rate point and per (config, corpus, policy).

Usage, on a machine with a CUDA device:

    python -m entropy_coders_tpu_torch.tools.policy_sweep
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..frame import compress, decompress
from ..normalize import normalize_batch
from ..ops.unsigned import resolve_device
from . import bench_configs as BC

CONFIGS = {
    "bench": {"block_size": 16 << 20, "k": 16384},
    "default": {"block_size": 128 << 10, "k": 1024},
}
POLICIES = [
    ("fixed10", 10),
    ("auto", "auto"),
    ("fast_p25", ("fast", 0.0025)),
    ("fast_p50", ("fast", 0.005)),
    ("fast_p100", ("fast", 0.01)),
]
LS = [8, 9, 10, 11]
SIZE = 32 << 20
CORPORA = ("geo", "text", "bf16", "jsonlog")


def _roundtrip(comp: bytes, data: np.ndarray, device, what: str) -> None:
    if decompress(comp, device=device) != data.tobytes():
        raise RuntimeError(f"policy sweep ({what}): round trip")


def measure_rates(data, cfg, *, device="cuda", out=print) -> dict:
    """B1's decode rate (GB/s) at each fixed table log of ``LS`` on
    ``data`` at ``cfg``; ``out`` takes one JSON line per L (the rate, its
    runs, the ratio)."""
    rates = {}
    for L in LS:
        comp = compress(data, table_log=L, lanes=True, device=device, **cfg)
        _roundtrip(comp, data, device, f"L={L}")
        rate = BC.device_decode_gbps(comp, cfg["block_size"], cfg["k"],
                                     data=data, device=device)
        rates[L] = rate.GBps
        out(json.dumps({"rate_point": {
            "config": cfg, "L": L, "decode_GBps": rate.GBps,
            "decode_ms": rate.ms, "decode_ms_runs": rate.runs_ms,
            "decode_enqueue_ms": rate.enqueue_ms,
            "blocks": rate.blocks, "launches": rate.launches,
            "ratio": len(comp) / len(data)}}))
    return rates


def chosen_logs(data, cfg, table_log) -> np.ndarray:
    """Per-block table logs a policy picks for ``data``'s whole blocks at
    ``cfg`` (host only)."""
    bs = cfg["block_size"]
    B = len(data) // bs
    blocks = np.asarray(data)[: B * bs].reshape(B, bs)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    _, log2s = normalize_batch(counts, bs, table_log)
    return log2s


def eff_decode_gbps(n_bytes: int, log2s, block_size: int, rates) -> float:
    """The effective rate (GB/s): ``n_bytes`` over the time of each block
    at its log's rate, a log without a rate taking L=11's."""
    uniq, cnt = np.unique(log2s, return_counts=True)
    return n_bytes / sum(
        int(c) * block_size / (rates.get(int(l), rates[max(LS)]) * 1e9)
        for l, c in zip(uniq, cnt)) / 1e9


def sweep_row(cname: str, dname: str, data, pname: str, policy, rates, *,
              device="cuda") -> dict:
    """One (config, corpus, policy) row: compress at the policy, check the
    round trip, and the chosen logs and effective rate under ``rates``."""
    cfg = CONFIGS[cname]
    t0 = time.perf_counter()
    comp = compress(data, table_log=policy, lanes=True, device=device, **cfg)
    t_c = time.perf_counter() - t0
    _roundtrip(comp, data, device, f"{cname} {dname} {pname}")
    log2s = chosen_logs(data, cfg, policy)
    uniq, cnt = np.unique(log2s, return_counts=True)
    return {"config": cname, "corpus": dname, "policy": pname,
            "ratio": len(comp) / len(data),
            "eff_decode_GBps": eff_decode_gbps(len(data), log2s,
                                               cfg["block_size"], rates),
            "logs": {int(l): int(c) for l, c in zip(uniq, cnt)},
            "compress_s": t_c}


def sweep(device="cuda", corpora=None, out=print) -> dict:
    """Every config's rates on geo, then every row; ``out`` takes each JSON
    line. Returns {"rates": {config: {L: GB/s}}, "rows": [...]}."""
    corpora = corpora or BC.Corpora()
    data_by_name = {name: corpora.get(name, SIZE) for name in CORPORA}
    all_rates, rows = {}, []
    for cname, cfg in CONFIGS.items():
        rates = all_rates[cname] = measure_rates(data_by_name["geo"], cfg,
                                                 device=device, out=out)
        for dname, data in data_by_name.items():
            for pname, policy in POLICIES:
                row = sweep_row(cname, dname, data, pname, policy, rates,
                                device=device)
                rows.append(row)
                out(json.dumps(row))
    out(json.dumps({"done": len(rows)}))
    return {"rates": all_rates, "rows": rows}


def main(argv) -> int:
    from ..kernels.build import load

    resolve_device("cuda")  # raises without CUDA: the rates are device numbers
    load()
    sweep(out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
