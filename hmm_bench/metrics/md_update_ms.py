"""md_update_ms (ms/step): wall time of ``MDBackend.update`` per macro-step,
bracketed by synchronisations in the traced run; moves macro_step_s."""


def read(ctx):
    spans = ctx.get("md_update_s") or []
    if not spans:
        return None
    return 1e3 * sum(spans) / ctx["steps"]
