"""Stage-by-stage wall-time profile of the accelerate() pack pipeline
(VERDICT r4 item 2: the L=24 pack had no breakdown, so it could not be
attacked).  Runs on the HOST — the pack is host-side by design.

Usage: python benchmarks/profile_pack.py [L] [n_up]
"""

import json
import os
import sys
import time

# the pack is host work: run JAX on the CPU so device_put times the host
# pipeline, not a transfer to a card
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from eigenex_tpu import native
from eigenex_tpu.sparse.accelerate import accelerate


def main():
    L = int(sys.argv[1]) if len(sys.argv) > 1 else 22
    n_up = int(sys.argv[2]) if len(sys.argv) > 2 else L // 2
    t0 = time.time()
    # open chain — the BASELINE config-3 operator (bench_heisenberg.py)
    rows, cols, vals, dim = native.heisenberg_sector(L, n_up, 1.0, 1.0, False)
    t_build = time.time() - t0
    print(f"L={L} sector dim={dim} nnz={len(vals)} build={t_build:.1f}s")

    t0 = time.time()
    acc = accelerate(
        (rows, cols, vals, (dim, dim)), symmetric=True, symmetric_check=True
    )
    total = time.time() - t0
    st = acc.stats
    print(json.dumps({
        "pack_seconds": round(total, 2),
        "us_per_nnz": round(total / len(vals) * 1e6, 3),
        "stages": st["pack_stages"],
        "bandwidth": [st["bandwidth_before"], st["bandwidth_after"]],
        "fill": round(st["fill"], 5),
        "dtype": st["dtype"],
        "ku": st.get("ku"),
        "band_reach": st.get("band_reach"),
    }, indent=1))


if __name__ == "__main__":
    main()
