"""Generate tests/data/oracle_gate.npz — the float64 direct-Ewald reference
for the end-to-end on-card oracle gates of bench.py and chip_smoke.py.

Engine-vs-engine checks bound kernel-vs-kernel agreement, but not the
COMPOSED on-card error (far-field dtype, reduced-precision products, FFT)
vs the physics.  This file pins one direct measurement: U = M·F for a dense-ish
random config, summed in float64 with exact (untabulated) pair functions
and an explicit k-lattice wave sum (tests/oracles.py), cached so the gate
costs one mobility call, not an O(N²) host sum.

Run ONCE on CPU (takes a few minutes at n=2048):
    JAX_PLATFORMS=cpu python tools/make_oracle_gate.py
and, for the dense error=1e-4 gate (tests/data/oracle_dense.npz):
    JAX_PLATFORMS=cpu python tools/make_oracle_gate.py --dense
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

N = 2048
PHI = 0.45
XI = 0.5
SEED = 13
PATH = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                    "oracle_gate.npz")
# test_physics.test_dense_error_knob_scales_accuracy's configuration
# (φ=0.45, N=2000, error=1e-4), for chip_smoke.py's strict-accuracy gate
DENSE_PATH = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                          "oracle_dense.npz")


def dense_case(n=2000, phi=0.45, seed=12):
    """(pos, forces, L): jittered vacancy lattice under unit z forces."""
    import math

    L = (n * (4.0 / 3.0) * math.pi / phi) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    n_side = int(math.ceil(n ** (1.0 / 3.0)))
    a = L / n_side
    g = (np.arange(n_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    p = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    keep = np.sort(rng.choice(p.shape[0], size=n, replace=False))
    p = (p[keep] + rng.normal(scale=0.05 * a, size=(n, 3))).astype(np.float32)
    f = np.zeros((n, 3), np.float32)
    f[:, 2] = 1.0
    return p, f, L


def main_dense():
    import oracles

    pos, forces, L = dense_case()
    t0 = time.time()
    u_ref = oracles.direct_ewald_velocity(pos, forces, (L, L, L), XI)
    print(f"dense oracle sum: {time.time() - t0:.1f}s")
    np.savez_compressed(
        DENSE_PATH, pos=pos, forces=forces, u_ref=u_ref.astype(np.float64),
        L=np.float64(L), xi=np.float64(XI), error=np.float64(1e-4),
    )
    print(f"wrote {DENSE_PATH}")


def main():
    from bench import make_positions
    import oracles

    pos, L = make_positions(N, PHI, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    forces = rng.normal(size=(N, 3)).astype(np.float32)

    t0 = time.time()
    u_ref = oracles.direct_ewald_velocity(
        pos.astype(np.float64), forces.astype(np.float64),
        (L, L, L), XI,
    )
    print(f"oracle sum: {time.time() - t0:.1f}s")

    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(
        PATH, pos=pos.astype(np.float32), forces=forces,
        u_ref=u_ref.astype(np.float64), L=np.float64(L), xi=np.float64(XI),
        n=np.int64(N), phi=np.float64(PHI),
    )
    print(f"wrote {PATH}: n={N} L={L} xi={XI} "
          f"|u|={np.linalg.norm(u_ref):.6e}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--dense"]:
        main_dense()
    else:
        main()
