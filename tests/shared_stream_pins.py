"""The JAX package's frames that chip_smoke.py pins for its phase
``shared_stream`` (``SHARED_STREAM``): bytes and sha256 of
``entropy_coders_tpu.frame.compress`` on the CPU, for the same input and
knobs as the phase (chip_smoke.py's 128 MiB bench data, ``gen_sequence(0.2,
BENCH_SIZE, BENCH_SEED)`` of tests/data/generate_golden.py; 128 KiB blocks,
``lanes=False``, k = 1024 and k = 2).

    JAX_PLATFORMS=cpu python tests/shared_stream_pins.py

prints one JSON line a point (7-10 s each) and exits 1 if a frame differs
from the pinned one. The card that runs chip_smoke.py has no JAX, so the
script carries the numbers; this is how they are made.
``tests/test_torch_coder_emulated.py`` runs ``pins`` at a small size
against the port's frames."""

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def pins(size: int = chip_smoke.BENCH_SIZE) -> dict:
    """{point: (frame bytes, sha256)} of the JAX package's frames for the
    first ``size`` bytes of the bench data."""
    from entropy_coders_tpu import frame as JF

    data = chip_smoke.load_testdata().gen_sequence(0.2, size,
                                                  chip_smoke.BENCH_SEED)
    out = {}
    for name, (knobs, _, _) in chip_smoke.SHARED_STREAM.items():
        frame = JF.compress(data, **knobs)
        out[name] = (len(frame), hashlib.sha256(frame).hexdigest())
    return out


def main() -> int:
    ok = True
    for name, (nbytes, sha) in pins().items():
        _, want_bytes, want_sha = chip_smoke.SHARED_STREAM[name]
        same = (nbytes, sha) == (want_bytes, want_sha)
        ok &= same
        print(json.dumps({"point": name, "frame_bytes": nbytes,
                          "sha256": sha, "pinned": same}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
