"""Command-line interface of the port (counterpart of
``entropy_coders_tpu/__main__.py``, with its commands and flags).

Usage:
    python -m entropy_coders_tpu_torch compress   <in> <out> [--block-size N]
        [--k N] [--table-log N|auto|fast|fast:EPS] [--shared-table]
        [--no-lanes] [--checksum] [--bit-pack]
    python -m entropy_coders_tpu_torch decompress <in> <out>
    python -m entropy_coders_tpu_torch stat       <in>
    python -m entropy_coders_tpu_torch warmup    [--mib N] [--table-log N]

``ECT_PLATFORM`` selects the device the block work runs on: ``cuda`` (the
default: the hand-written kernels, built at first use) or ``cpu`` (their
plain PyTorch versions). Without CUDA, and without ``ECT_PLATFORM=cpu``,
every command but ``stat`` raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_PLATFORMS = ("cuda", "cpu")


def _parse_table_log(v: str):
    """'auto' | 'fast' | 'fast:EPS' | int — the frame.compress forms."""
    if v in ("auto", "fast"):
        return v
    if v.startswith("fast:"):
        return ("fast", float(v[5:]))
    return int(v)


def _platform() -> str:
    plat = os.environ.get("ECT_PLATFORM") or "cuda"
    if plat not in _PLATFORMS:
        raise ValueError(f"ECT_PLATFORM={plat!r}: want one of {_PLATFORMS}")
    return plat


def _launches(device) -> str:
    """The kernel launches of this process, where the work ran on CUDA."""
    if device.type != "cuda":
        return ""
    from .ops import device_repack as DR
    from .ops import pl_coder as PL
    from .ops import tables as TB

    return (f"; kernel launches: encode {PL.ENCODE_LAUNCHES}, "
            f"decode {PL.DECODE_LAUNCHES}, merge {DR.MERGE_LAUNCHES}, "
            f"split {DR.SPLIT_LAUNCHES}, tables {TB.TABLE_LAUNCHES}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="entropy_coders_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("--block-size", type=int, default=None)
    c.add_argument("--k", type=int, default=None)
    c.add_argument("--table-log", default=None, type=_parse_table_log,
                   help="5..15, 'auto' (per-block ratio-optimal), 'fast' "
                        "(smallest log within 0.5%% of auto's estimated "
                        "size), or 'fast:EPS' for an explicit size budget "
                        "(e.g. fast:0.015)")
    c.add_argument("--shared-table", action="store_true")
    c.add_argument("--no-lanes", action="store_true")
    c.add_argument("--checksum", action="store_true")
    c.add_argument("--bit-pack", action="store_true",
                   help="bit-pack lane streams (FLAG_PACKED; smaller, "
                        "slower host repack)")

    d = sub.add_parser("decompress")
    d.add_argument("infile")
    d.add_argument("outfile")

    s = sub.add_parser("stat")
    s.add_argument("infile")

    w = sub.add_parser(
        "warmup",
        help="build the kernels and round-trip a synthetic corpus at each "
             "table log the default policy lands on")
    w.add_argument("--mib", type=int, default=64,
                   help="synthetic corpus size; 64 covers the chunked "
                        "pipeline's full-chunk shape (default 64)")
    w.add_argument("--block-size", type=int, default=None)
    w.add_argument("--k", type=int, default=None)
    w.add_argument("--table-log", default=None, type=_parse_table_log)

    args = p.parse_args(argv)

    from . import frame as F
    from .ops.unsigned import resolve_device

    if args.cmd == "stat":
        from .utils import frame_stats

        with open(args.infile, "rb") as f:
            st = frame_stats(f.read())
        print(f"blocks={st.n_blocks} block_size={st.block_size} k={st.k} "
              f"shared={st.shared_table} modes={st.mode_counts} "
              f"table_logs={st.table_log_counts}")
        print(f"ratio={st.ratio:.4f} header_bytes={st.header_bytes} "
              f"lane_tables={st.lane_size_table_bytes} "
              f"overhead={st.overhead:.4%}")
        return 0

    device = resolve_device(_platform())
    if args.cmd == "compress":
        from .stream import compress_file

        kw = {"device": device}
        if args.block_size:
            kw["block_size"] = args.block_size
        if args.k:
            kw["k"] = args.k
        if args.table_log:
            kw["table_log"] = args.table_log
        if args.no_lanes:
            kw["lanes"] = False
        if args.checksum:
            kw["checksum"] = True
        if args.bit_pack:
            kw["bit_pack"] = True
        t0 = time.perf_counter()
        if args.shared_table:
            # a shared table needs the whole-file histogram: non-streaming
            with open(args.infile, "rb") as f:
                data = f.read()
            comp = F.compress(data, shared_table=True, **kw)
            with open(args.outfile, "wb") as f:
                f.write(comp)
            n_in, n_out = len(data), len(comp)
        else:
            n_out = compress_file(args.infile, args.outfile, **kw)
            n_in = os.path.getsize(args.infile)
        dt = time.perf_counter() - t0
        print(f"{n_in} -> {n_out} bytes "
              f"(ratio {n_out/max(n_in,1):.4f}) in {dt:.2f}s on {device}"
              f"{_launches(device)}",
              file=sys.stderr)
    elif args.cmd == "decompress":
        from .stream import decompress_file

        t0 = time.perf_counter()
        n_out = decompress_file(args.infile, args.outfile, device=device)
        dt = time.perf_counter() - t0
        print(f"{os.path.getsize(args.infile)} -> {n_out} bytes in {dt:.2f}s "
              f"on {device}{_launches(device)}", file=sys.stderr)
    else:
        import numpy as np

        t0 = time.perf_counter()
        if device.type == "cuda":
            from .kernels import build

            build.load()
            print(f"warmup: kernels ready in {time.perf_counter() - t0:.1f}s "
                  f"({build.library_path()})", file=sys.stderr)
        kw = {"device": device}
        if args.block_size:
            kw["block_size"] = args.block_size
        if args.k:
            kw["k"] = args.k
        # Zipf keeps all 256 symbols present yet compressible (uniform
        # bytes would RAW-escape and reach no kernel)
        rng = np.random.default_rng(0xF5E)
        data = (rng.zipf(1.3, args.mib << 20) % 256).astype(np.uint8)
        # the logs the default ("fast", 0.0025) policy lands on across
        # corpora (8..11), or just the one the user pinned
        logs = [args.table_log] if args.table_log else [8, 9, 10, 11]
        for L in logs:
            t1 = time.perf_counter()
            comp = F.compress(data, table_log=L, **kw)
            if F.decompress(comp, device=device) != data.tobytes():
                raise RuntimeError(f"warmup round trip failed at L={L}")
            print(f"warmup L={L}: {args.mib} MiB round trip in "
                  f"{time.perf_counter() - t1:.1f}s", file=sys.stderr)
        print(f"warmup done in {time.perf_counter() - t0:.1f}s on {device}"
              f"{_launches(device)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
