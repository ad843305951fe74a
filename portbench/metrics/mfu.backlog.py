"""The whole dispatch's share of the card's peak: the window cores'
counted operations over the f32 peak, or their counted bytes over
3.35 TB/s, whichever is larger, over the dispatches' host time, in %."""
from portbench import counts


def read(ctx):
    if not ctx.get("dispatch_s"):
        return None
    cfg = ctx["cfg"]
    c = cfg["cough"]
    per = {"cough": counts.cough_window(
        c["fft_n"], c["audio_channels"], int(c["audio_sr"] * c["window_s"]),
        c["imu_channels"], int(c["imu_sr"] * c["window_s"]),
        trees=cfg["forest"]["trees"]),
        "rpeak": counts.rpeak_window(
            int(cfg["rpeak"]["fs"] * cfg["rpeak"]["window_s"]))}
    flops = sum(per[task]["flops"] * n
                for task, n in ctx["windows_by_task"].items())
    nbytes = sum(per[task]["bytes"] * n
                 for task, n in ctx["windows_by_task"].items())
    return 100.0 * counts.bound_s(flops, nbytes) / ctx["dispatch_s"]
