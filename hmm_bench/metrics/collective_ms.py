"""collective_ms (ms/step): the device time of the NCCL kernels (the job
inputs' broadcast and the five all-gathers of the MD results) on rank 0's
card, per macro-step of the traced run, from the device operations that
took most time (``ctx["device_ops"]``); the wait for the slowest rank
falls inside them.  A kind outside those ten is not counted: on rank 0,
the broadcast's source, the broadcast kernel can be one (0.03 ms a step
on four H100s against 31 ms of all-gathers).  None where no NCCL kernel
ran; moves macro_step_s."""


def read(ctx):
    ops = [s for name, s in ctx.get("device_ops") or [] if "nccl" in name.lower()]
    if not ops or not ctx.get("steps"):
        return None
    return 1e3 * sum(ops) / ctx["steps"]
