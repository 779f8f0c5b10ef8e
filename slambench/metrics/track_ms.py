"""Mean host-clock span of the calls into the track layer over the traced
window, each span synchronized at both ends; None where the window made no
such call."""


def read(ctx):
    s = ctx.get("spans", {}).get("track")
    return 1e3 * sum(s) / len(s) if s else None
