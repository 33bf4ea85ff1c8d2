"""Shared set-up of the tests that hold K4's plain version to the JAX
package's gather-list Pallas kernel in interpret mode
(tests/test_torch_list_{resident,streamed,run,sample}.py): the 56-atom
COMMON fixture of tests/test_torch_allatom.py with ``force_list_kernel``
(K = 56, pattern bonds, SHAKE, the Ewald k-space split), JAX's relaxed
state and a Maxwell draw, handed to the port through ``interop``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM
from scema_tpu.ops import md_fused as JMF

from scema_tpu_torch import interop
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.ops import md_fused as TMF

COMMON = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
              pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
              use_ewald=True, force_list_kernel=True)
T_MD, DT = 50.0, 0.5
EPS = [0.01, 0.0, -0.01, 0.0, 0.0, 0.002]


def systems(**extra):
    """(JAX's fused list system, its relaxed state with velocities, the
    port's list system on the CPU, the same state in the port)."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, use_fused=True, **{
        k: v for k, v in extra.items()}))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, **{
        k: v for k, v in extra.items() if k != "force_k_chunk"}), device="cpu")
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=50, dt0=0.25))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(9), T_MD))
    return jsys, jst, tsys, interop.md_state(jst)


def fused_chunk_vs_plain(jsys, jst, tsys, n_run=10, gstep0=0, n_tot=20):
    """One deform chunk of JAX's ``fused_chunk`` (its list branch, with
    JAX's own channels and frozen k-space force) and of the port's plain
    ``md_run`` fed the same channels through ``interop``.  Returns
    (max |pos| diff A, max |vel| diff, max |vxi| diff)."""
    jr, spec, n = jsys.fused, jsys.fused.spec, jsys.n_atoms
    dtype = jst.pos.dtype
    fk = jr.kspace_fn(jst.pos, jst.h)
    ch = jr.channels(jst.pos, jst.h)
    st8 = JMF.pack_state(jst.pos, jst.vel, jr.masses, spec.ftm2v, dtype=dtype)
    fscal = JMF.make_fscal(DT, T_MD, jst.h, eps=jnp.asarray(EPS), vxi=jst.vxi, dtype=dtype)
    iscal = JMF.make_iscal(n_run, gstep0, n_tot)
    st8, sacc = JMF.fused_chunk(spec, st8, {**ch, "fext": JMF.pack_fext(fk, n, dtype)}, iscal,
                                fscal, deform=True, sample=False)
    jpos, jvel = JMF.unpack_state(st8, n)

    tst = interop.md_state(jst)
    nbr = interop.list_channels(ch, n)
    state = TMF.pack_state(tst.pos[None], tst.vel[None])
    tf = TMF.make_fscal(DT, T_MD, tst.h[None], torch.tensor([EPS], dtype=torch.float64))
    fk_t = torch.as_tensor(np.array(fk)).T[None].contiguous()
    out, vxi, _ = TMF.md_run(tsys.fused, state, tst.vxi[None], torch.tensor([n_run]), tf, True,
                             False, fk_t, torch.tensor([gstep0]), torch.tensor([n_tot]), nbr=nbr)
    pos, vel = TMF.unpack_state(out)
    return (float(np.abs(pos[0].numpy() - np.asarray(jpos)).max()),
            float(np.abs(vel[0].numpy() - np.asarray(jvel)).max()),
            float(np.abs(vxi[0].numpy() - np.asarray(JMF.sacc_vxi(sacc))).max()))
