"""device_idle_share (%): the share of the traced window's wall time in
which no operation ran on the device (1 - union of the device intervals /
window); moves macro_step_s."""


def read(ctx):
    busy, window = ctx.get("busy_s"), ctx.get("window_s")
    if not window or busy is None:
        return None
    return 100.0 * (1.0 - busy / window)
