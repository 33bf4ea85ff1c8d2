"""Densities after the staged material prep (``equilibrate_staged``) of
the g0 melt, the 216-atom SW silicon box and the charged all-atom PE box
``material.PEAA``, from the JAX package and from the port on the same
Maxwell draws, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_staged_density.py [--ns-init 100]
        [--keys 1 2] [--dtype float64] [--materials g0 si peaa]

The JAX package runs its XLA engine (autograd energies over a neighbor
list; on PEAA the exact Ewald/PME sum every step and SHAKE/RATTLE); the
port runs its default route (the plain versions of K1's, K5's or K3's
force + virial entries, K3's run for PEAA's NVT stage) with JAX's 200 K
draw injected.  Both
trajectories are chaotic over ~1100 steps, so the densities agree as
ensembles, not digit for digit.  The reference's prep is what sets them:
the g0 octane melt expands while it is held at 500 K, and the SW silicon
box melts because the reference reads the metal-units Si.sw energies (eV)
as kcal/mol under ``units real`` (scema_tpu/md/units.py), a potential ~23x
softer than silicon's.  chip_smoke.py phases 17 and 22 take their density
bands from this script's output.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scema_tpu.md import box as JB  # noqa: E402
from scema_tpu.md import engine as JE  # noqa: E402
from scema_tpu.md import material as JM  # noqa: E402
from scema_tpu.md.homogenization import MDParams as JParams  # noqa: E402

from scema_tpu_torch.md import box as TB  # noqa: E402
from scema_tpu_torch.md import material as TM  # noqa: E402
from scema_tpu_torch.md.homogenization import MDParams  # noqa: E402

PARAMS = dict(temperature=300.0, dt=2.0, strain_rate=1e-4, nsteps_sample=100)
# PEAA: the port's material.PEAA (the JAX package's bench.py _allatom_spec)
SPECS = {"g0": dict(name="g0", force_field="opls"), "si": dict(name="si", force_field="sw"),
         "peaa": {k: v for k, v in TM.PEAA.__dict__.items() if k in (
             "name", "force_field", "allatom", "n_chains", "chain_length", "pe_density",
             "opls_lj_cutoff", "opls_coul_cutoff", "use_ewald", "kspace_every", "kspace")}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ns-init", type=int, default=100)
    p.add_argument("--keys", type=int, nargs="+", default=[1, 2])
    p.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    p.add_argument("--materials", nargs="+", default=["g0", "si"], choices=list(SPECS))
    args = p.parse_args(argv)
    minimize = 80 if args.ns_init == 60 else 100  # test_opls_hmm.py:76-77 at ns_init 60
    for name in args.materials:
        # JAX on its XLA engine (use_fused=False: its CPU default for these boxes)
        jsys, jst = JM.build_system(JM.MaterialSpec(**SPECS[name], use_fused=False),
                                    dtype=getattr(jax.numpy, args.dtype))
        tsys, tst = TM.build_system(TM.MaterialSpec(**SPECS[name]),
                                    dtype=getattr(torch, args.dtype), device="cpu")
        mass = float(torch.sum(tsys.masses))
        for key in args.keys:
            k = jax.random.PRNGKey(key)
            t0 = time.perf_counter()
            jout = JM.equilibrate_staged(jsys, jst, JParams(**PARAMS), k,
                                         ns_init=args.ns_init, minimize_steps=minimize)
            rho_j = mass * TM.DENSITY_CONV / float(JB.volume(jout.h))
            t1 = time.perf_counter()
            draw = torch.as_tensor(np.array(JE.maxwell_velocities(jsys, k, 200.0)))
            tout = TM.equilibrate_staged(tsys, tst, MDParams(**PARAMS), ns_init=args.ns_init,
                                         minimize_steps=minimize, velocities=draw)
            rho_t = mass * TM.DENSITY_CONV / float(TB.volume(tout.h))
            print(f"{name} ns_init {args.ns_init} {args.dtype} key {key}: JAX {rho_j:.2f} "
                  f"kg/m^3 ({t1 - t0:.1f}s), port {rho_t:.2f} kg/m^3 "
                  f"({time.perf_counter() - t1:.1f}s, {tsys.fused.spec.kernel} plain entry); "
                  f"port/JAX {rho_t / rho_j:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
