"""The comparison that decides ``correct``.

The window replays a fixed segment of macro-steps from one kept carry.
After it has closed, each step of the last segment is followed from the
program's own input carry of that step: the reference redoes the FE
predictor (displacement increments, qp strains, MD flags), the clustering
and job selection, the MD jobs (from each job's own microstate) and the
bridging and FE corrector (replica averaging with the init stress taken
off, the stress update, the reaction, the new displacements), and every
result is held against what the program produced.  The corrector takes the
program's MD stresses as its input, so an MD fault shows in the MD
numbers and an FE or bridging fault in the FE numbers.  Every MD job of
the segment's first step is rerun; of the later steps a sample drawn from
the seed, with the job of the most MD steps in it.

The reference also works out again what the set-up derived from the
prepared boxes: their density and edge lengths and, by its own sampling
run from each prepared replica, the init stress that bridging takes off.
The prepared boxes themselves, the staged NPT prep's output, are the
program's state that the reference starts from, as it starts each step
from the program's carry: the prep is not redone here.

Each number compared has its limit in :data:`LIMITS`; ``correct`` is true
when every number is finite and within its limit.  The control (the
reference in bfloat16 in the program's place) is judged by the same
limits on the numbers it has: it has no carry of its own to leave
unchanged.
"""
from __future__ import annotations

import math

import torch

from . import fe as RF
from . import md as RM

# g/mol per A^3 -> kg/m^3
DENSITY_CONV = 1660.539
# MD jobs rerun in each later step of the segment (every job of the first)
SAMPLE_JOBS = 32
# MD jobs per reference block (bounds the (B, N, N) pair temporaries)
BLOCK_PAIRS = 2 ** 25

# name -> limit, each set between the program's readings over seeds and
# the control's (PERF.md, "How correct is decided")
LIMITS = {
    "fe_strain": 7e-5,
    "fe_stress": 3e-4,
    "fe_disp": 2e-5,
    "fe_residual": 3e-4,
    "qp_selection": 0,
    "md_stress": 0.2,
    "md_pos": 0.6,
    "md_box": 5e-5,
    "prep": 3e-5,
    "carry_unchanged": 0,
}


def fingerprint(carry) -> list:
    """Exact sums of every tensor of a carry, to see that the window's
    steps left the kept carry as it was."""
    fe, micros = carry
    out = [float(t.double().sum()) for t in (fe.u, fe.v, fe.inc_u, fe.inc_v)]
    out += [float(getattr(fe.qp, f).double().sum()) for f in
            ("new_strain", "old_strain", "upd_strain", "newton_strain", "new_stress",
             "old_stress", "to_be_updated")]
    out += [float(fe.hist.buffer.double().sum()), float(fe.hist.count), float(fe.timestep)]
    for m in micros:
        out += [float(getattr(m, f).double().sum()) for f in ("pos", "vel", "h", "vxi",
                                                              "has_run")]
    return out


def _t(x, dtype, device):
    return x.detach().to(device=device, dtype=dtype)


def fe_view(fe, dtype, device) -> dict:
    """The FE state of a carry as the reference reads it."""
    qp = fe.qp
    d = {k: _t(getattr(qp, k), dtype, device) for k in
         ("new_stress", "new_strain", "upd_strain", "rotam", "stiff", "rho")}
    d.update(u=_t(fe.u, dtype, device), v=_t(fe.v, dtype, device),
             to_be_updated=qp.to_be_updated.to(device), timestep=int(fe.timestep),
             id_to_get=fe.hist.id_to_get_results_from.to(device))
    return d


class Reference:
    """The reference of one cell: its MD system, FE geometry and the
    replica data it works out again from the prepared boxes."""

    def __init__(self, conf: dict, sys: RM.System, prepared, device,
                 dtype=torch.float64):
        hmm = conf["hmm"]
        self.dtype, self.device = dtype, device
        mdp = hmm.get("molecular dynamics parameters", {})
        self.T = float(mdp.get("temperature", 300.0))
        self.dt = float(mdp.get("timestep length", 2.0))
        self.rate = float(mdp.get("strain rate", 1.0e-4))
        self.n_sample = int(mdp.get("number of sampling steps", 100))
        self.fe_dt = float(hmm.get("continuum time", {}).get("timestep length", 5.0e-7))
        self.min_norm = float(hmm.get("model precision", {}).get("md", {}).get(
            "min quadrature strain norm", 1.0e-10))
        self.min_steps = int(hmm.get("model precision", {}).get("clustering", {}).get(
            "min steps", 500))
        self.capacity = int(hmm.get("computational resources", {}).get("maximum md jobs", 0))
        # the FE runs on the CPU: a few hundred qps, summed in a fixed order
        self.fe_dev = "cpu"
        self.mesh = hmm.get("continuum mesh", {})
        self.rate_fe = float(hmm.get("problem type", {}).get("strain rate", 0.002))
        self.g, self.bc = self.fe_of(dtype)
        self.sys = sys.to(device, dtype)
        self.checked = {}
        # the replicas' frames: no orientation file is configured, so each
        # replica's frame is the common ground
        self.prepared = prepared  # stacked over replicas: pos, vel (R, N, 3), h, vxi
        R = prepared.pos.shape[0]
        self.rotam = torch.eye(3, dtype=dtype, device=self.fe_dev).expand(R, 3, 3)
        self.rho, self.init_length, self.init_stress = self.start(dtype)

    def start(self, dtype):
        """What the set-up derives from the prepared replicas, worked out
        again in ``dtype``: (density, edge lengths (R, 3), init stress (R, 6)
        by an NVT sampling run from each replica)."""
        st = self.prepared
        h = st.h.to(dtype=dtype, device=self.fe_dev)
        length = torch.stack([h[:, 0, 0], h[:, 1, 1], h[:, 2, 2]], -1)
        vol = h[:, 0, 0] * h[:, 1, 1] * h[:, 2, 2]
        mass = self.sys.masses.to(dtype).sum().to(self.fe_dev)
        rho = float(torch.mean(mass * DENSITY_CONV / vol))
        sysd = self.sys if dtype == self.dtype else self.sys.to(self.device, dtype)
        _, _, _, pacc = RM.run(sysd, _t(st.pos, dtype, self.device), _t(st.vel, dtype, self.device),
                               _t(st.vxi, dtype, self.device), _t(st.h, dtype, self.device),
                               torch.full((st.pos.shape[0],), self.n_sample, device=self.device),
                               self.dt, self.T, sample=True)
        return rho, length, (-(pacc / self.n_sample) * RM.ATM_TO_PA).to(self.fe_dev)

    def fe_of(self, dtype):
        """(geometry, boundary conditions) in ``dtype``."""
        g = RF.geometry(self.mesh, dtype, self.fe_dev)
        return g, RF.dogbone(g, self.rate_fe, self.fe_dt, dtype, self.fe_dev)

    # -- one step -----------------------------------------------------------

    def md_jobs(self, micro, src, dlength, dtype):
        """Rerun the MD jobs ``src`` (their start microstates) with length
        variations ``dlength`` (jobs, R, 6), in blocks of runs of like
        length; returns (pos, h, stress (jobs, R, 6), nts (jobs, R))."""
        n = micro.pos.shape[-2]
        J, R = src.shape[0], micro.pos.shape[1]
        step = max(1, BLOCK_PAIRS // (n * n))
        sysd = self.sys if dtype == self.dtype else self.sys.to(self.device, dtype)
        flat = {f: getattr(micro, f)[src].flatten(0, 1) for f in ("pos", "vel", "h", "vxi")}
        dl = dlength.flatten(0, 1)
        _, nts = RM.job_steps(flat["h"].to(device=dl.device, dtype=dl.dtype), dl, self.rate,
                              self.dt)
        order = torch.argsort(nts, stable=True)
        outs = []
        for s in range(0, dl.shape[0], step):
            sl = order[s:s + step]
            p, v, xi, h, sig, nt = RM.strain_and_sample(
                sysd, *(_t(flat[f][sl.to(flat[f].device)], dtype, self.device)
                        for f in ("pos", "vel", "vxi", "h")),
                _t(dl[sl], dtype, self.device), self.rate, self.dt, self.T, self.n_sample)
            outs.append((p, h, sig, nt))
        back = torch.argsort(order)
        cat = [torch.cat([o[k] for o in outs])[back.to(outs[0][k].device)] for k in range(4)]
        return (cat[0].reshape(J, R, n, 3), cat[1].reshape(J, R, 3, 3),
                cat[2].reshape(J, R, 6), cat[3].reshape(J, R))

    def plan(self, c_in, step_pos: int, seed: int):
        """The MD jobs rerun in the segment's step ``step_pos`` from carry
        ``c_in``: every job in the first step; in a later one a sample of
        :data:`SAMPLE_JOBS` drawn from the seed, with the job of the most
        MD steps in it."""
        fe_in, micros = c_in
        micro = micros[0]
        st = fe_view(fe_in, self.dtype, self.fe_dev)
        pred = RF.predict(self.g, self.bc, st, self.fe_dt, self.min_norm)
        n_qp = pred["flags"].shape[0]
        id_to_get = RF.cluster_ids(pred["timestep"], n_qp, self.min_steps, self.fe_dev)
        jobs = pred["flags"] & (id_to_get == torch.arange(n_qp))
        job_idx = RF.select_jobs(jobs, pred["timestep"], min(self.capacity or n_qp, n_qp))
        chk = job_idx
        if step_pos > 0 and job_idx.numel() > SAMPLE_JOBS:
            src = RF.job_sources(job_idx.to(micro.has_run.device), micro.has_run,
                                 fe_in.hist.id_to_get_results_from.to(micro.has_run.device))
            dl = RF.length_variation(pred["update_strain_cg"][job_idx], self.rotam,
                                     self.init_length)
            h = micro.h[src].to(device=self.fe_dev, dtype=self.dtype)
            _, nts = RM.job_steps(h.flatten(0, 1), dl.flatten(0, 1), self.rate, self.dt)
            longest = job_idx[int(torch.argmax(nts.reshape(job_idx.numel(), -1).amax(-1)))]
            gen = torch.Generator().manual_seed(int(seed) * 7919 + step_pos)
            chk = job_idx[torch.randperm(job_idx.numel(), generator=gen)[:SAMPLE_JOBS]]
            if not bool((chk == longest).any()):
                chk[0] = longest
            chk = torch.sort(chk).values
        self.checked[step_pos] = int(chk.numel())
        return chk

    def step(self, c_in, prog_stress_repl, check_jobs, dtype=None) -> dict:
        """The reference's outputs of the step from carry ``c_in``: the FE
        and selection outputs over every qp, the MD outputs of the qps
        ``check_jobs`` (None: every job), and the corrector's outputs from
        the program's per-replica MD stresses ``prog_stress_repl``."""
        dtype = dtype or self.dtype
        fe_in, micros = c_in
        micro = micros[0]
        g, bc = (self.g, self.bc) if dtype == self.dtype else self.fe_of(dtype)
        st = fe_view(fe_in, dtype, self.fe_dev)
        st["rho"] = torch.full_like(st["rho"], self.rho)
        pred = RF.predict(g, bc, st, self.fe_dt, self.min_norm)
        n_qp = pred["flags"].shape[0]
        id_to_get = RF.cluster_ids(pred["timestep"], n_qp, self.min_steps, self.fe_dev)
        jobs = pred["flags"] & (id_to_get == torch.arange(n_qp))
        cap = self.capacity or n_qp
        job_idx = RF.select_jobs(jobs, pred["timestep"], min(cap, n_qp))
        has_result = torch.zeros_like(jobs)
        has_result[job_idx] = True
        out = dict(strain_cg=pred["update_strain_cg"], flags=pred["flags"], jobs=has_result,
                   id_to_get=id_to_get, residual0=pred["residual"],
                   residual0_scale=pred["residual_scale"])
        chk = job_idx if check_jobs is None else check_jobs
        if chk.numel():
            src = RF.job_sources(chk.to(micro.has_run.device), micro.has_run,
                                 fe_in.hist.id_to_get_results_from.to(micro.has_run.device))
            dl = RF.length_variation(pred["update_strain_cg"][chk], self.rotam.to(dtype),
                                     self.init_length.to(dtype))
            pos, h, sig, nts = self.md_jobs(micro, src, dl, dtype)
            out.update(md_pos=pos, md_h=h, md_stress=sig)
        # bridging and the corrector, from the program's MD stresses
        srep = prog_stress_repl.to(dtype=dtype, device=self.fe_dev)[job_idx]
        upd = torch.zeros((n_qp, 6), dtype=dtype)
        upd[job_idx] = RF.average_replicas(srep, self.rotam.to(dtype),
                                           self.init_stress.to(dtype))
        cor = RF.correct(g, bc, st, pred, upd, id_to_get, self.fe_dt)
        out.update({k: cor[k] for k in ("new_stress", "u", "v", "residual1", "reaction",
                                        "residual1_scale", "reaction_scale")})
        # the stress update's rounding scale: its operands, the MD stress and
        # the init stress, not their difference
        out["stress_scale"] = max(float(cor["new_stress"].abs().max()),
                                  float(srep.abs().max() + self.init_stress.abs().max()))
        return out


def program_outputs(c_in, c_out, outs, check_jobs) -> dict:
    """What the program produced in one step, in the reference's terms."""
    fe, micros = c_out
    micro = micros[0]
    d = dict(strain_cg=outs.md_strain_cg, flags=fe.qp.to_be_updated, jobs=outs.md_ran,
             id_to_get=fe.hist.id_to_get_results_from, residual0=outs.residual0,
             residual1=outs.residual1, reaction=outs.reaction_force,
             new_stress=fe.qp.new_stress, u=fe.u, v=fe.v)
    if check_jobs is not None and check_jobs.numel():
        j = check_jobs.to(micro.pos.device)
        d.update(md_pos=micro.pos[j], md_h=micro.h[j],
                 md_stress=outs.md_stress_repl[j.to(outs.md_stress_repl.device)])
    return d


def _rel(a, b, scale=None) -> float:
    """max |a - b| over ``scale`` (default max |b|), in float64; inf where a
    is not finite."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    if not bool(torch.isfinite(a).all()):
        return math.inf
    scale = float(b.abs().max()) if scale is None else scale
    return float((a - b).abs().max() / max(scale, 1e-300))


def gaps(cand: dict, ref: dict) -> dict:
    """The numbers compared for one step: each the worst gap of its kind."""
    g = {
        "fe_strain": _rel(cand["strain_cg"], ref["strain_cg"]),
        "fe_stress": _rel(cand["new_stress"], ref["new_stress"], ref["stress_scale"]),
        "fe_disp": max(_rel(cand["u"], ref["u"]), _rel(cand["v"], ref["v"])),
        "fe_residual": max(_rel(cand[k].reshape(1), ref[k].reshape(1), float(ref[k + "_scale"]))
                           for k in ("residual0", "residual1", "reaction")),
        "qp_selection": int(sum(int((cand[k].cpu() != ref[k].cpu()).sum())
                                for k in ("flags", "jobs", "id_to_get"))),
    }
    if "md_stress" in ref:
        sr = ref["md_stress"].double().cpu()
        sc = cand["md_stress"].double().cpu()
        per = sr.abs().amax(-1)  # (jobs, R)
        scale = torch.clamp(per, min=float(per.median()))
        g["md_stress"] = (math.inf if not bool(torch.isfinite(sc).all())
                          else float(((sc - sr).abs().amax(-1) / scale).max()))
        hr = ref["md_h"].double().cpu()
        g["md_box"] = _rel(cand["md_h"], hr)
        # positions by the minimum image of their difference in the
        # reference's final box
        d = cand["md_pos"].double().cpu() - ref["md_pos"].double().cpu()
        hinv = torch.linalg.inv(hr)
        ds = d @ hinv.transpose(-1, -2)
        ds = ds - torch.round(ds)
        dd = ds @ hr.transpose(-1, -2)
        g["md_pos"] = (math.inf if not bool(torch.isfinite(dd).all())
                       else float(dd.norm(dim=-1).max()))
    return g


def worst(all_gaps: list) -> dict:
    """Per name, the worst reading over the steps."""
    out = {}
    for g in all_gaps:
        for k, v in g.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def start_gaps(ref: Reference, rho, init_length, init_stress) -> dict:
    """The start against the reference's: ``prep``, the worst relative gap
    of the per-qp density and the replicas' edge lengths; ``init_stress``,
    the init stress's worst gap over its largest component."""
    rho = torch.as_tensor(rho).double().cpu()
    sr = ref.init_stress.double().cpu()
    sc = torch.as_tensor(init_stress).double().cpu()
    return {"prep": max(float((rho - ref.rho).abs().max() / ref.rho),
                        _rel(init_length, ref.init_length)),
            "init_stress": (math.inf if not bool(torch.isfinite(sc).all()) else
                            float((sc - sr).abs().max() / max(float(sr.abs().max()), 1e-300)))}


def over_limit(numbers: dict) -> dict:
    """The numbers of ``numbers`` beyond their limits; one that is not
    finite is beyond."""
    return {k: v for k, v in numbers.items() if k in LIMITS and not v <= LIMITS[k]}


def is_correct(numbers: dict) -> bool:
    """Every number of :data:`LIMITS` given, and none beyond its limit."""
    return all(k in numbers for k in LIMITS) and not over_limit(numbers)

