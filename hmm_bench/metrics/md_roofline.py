"""md_roofline (%): the least time the traced steps' MD work could
take on the card (operations over the float32 peak or bytes over the HBM
rate, whichever is larger, counted from shapes, steps and live pairs,
whatever kernel runs it), over the device time of every kernel launched
inside ``MDBackend.update``; moves macro_step_s."""


def read(ctx):
    dev_s, min_s = ctx.get("md_device_s"), ctx.get("md_min_s")
    if not dev_s or not min_s:
        return None
    return 100.0 * min_s / dev_s
