"""Share of the profiled stretch that no device activity covers, both taken
from the trace: its span from the first device event or layer range to the
end of the last."""


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st["events"] or st["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
