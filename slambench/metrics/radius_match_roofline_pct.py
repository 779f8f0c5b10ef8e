"""`csrc/radius_match.cu`'s share of its roofline in the profiled stretch:
the mean least time of its calls (slambench/roofline.py, from each call's
shapes and candidate pairs) over the mean device time of its launches."""


def read(ctx):
    r = (ctx.get("stretch") or {}).get("radius")
    if not r or not r["calls"] or not r["launches"] or r["device_s"] <= 0:
        return None
    return 100.0 * (r["least_s"] / r["calls"]) / (r["device_s"] / r["launches"])
