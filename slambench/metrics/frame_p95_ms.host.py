"""95th percentile of every frame's latency over the traced window, host
clock: from the call that feeds the frame to the return of its FrameResult,
which ends in the session's own read of the device (the layer spans add a
synchronize at each layer call). None on an entry that dispatches ahead."""

import statistics


def read(ctx):
    lat = ctx.get("frame_s")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
