"""fe_cluster_ms (ms/step): the macro-step's wall time outside the MD
backend (FE predictor and corrector, clustering and K2, job packing,
bridging), per macro-step of the traced run; moves macro_step_s."""


def read(ctx):
    spans = ctx.get("md_update_s") or []
    if not spans or not ctx.get("step_s"):
        return None
    return 1e3 * (sum(ctx["step_s"]) - sum(spans)) / ctx["steps"]
