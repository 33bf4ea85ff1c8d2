"""The port's list path end to end against the JAX package's fused list
path in interpret mode: ``sample_stress`` of 10 steps with the list and
the k-space remainder (and its virial) refreshed every 5 steps (two
chunks): pressure 1e-10 relative, positions 1e-10 A (measured ~5e-15;
~60 s)."""
import numpy as np

from scema_tpu.ops import md_fused as JMF

from scema_tpu_torch.md import engine as TE

from torch_list_util import DT, T_MD, systems
from torch_port_util import rel_err


def test_sample_stress_matches_fused_list_path():
    jsys, jst, tsys, tst = systems(kspace_every=5, rebuild_every=5)
    js, jp = JMF.sample_stress_fused(jsys.fused, jst, 10, T_MD, DT)
    ts, tp = TE.sample_stress(tsys, tst, 10, T_MD, DT)
    assert rel_err(tp, np.asarray(jp)) < 1e-10
    assert np.abs(ts.pos.numpy() - np.asarray(js.pos)).max() < 1e-10
