"""The profile-DP kernels' share of their roofline over the traced
window: the least time of every recorded launch (``perfbench/
roofline.py``, from the R x C of each gap it fills) over the device time
of the fill (``tile_fill_kernel`` outside the band) and walk
(``profile_walk_kernel``) kernels, in %."""

from perfbench import roofline


def _is_profile_kernel(name):
    if "profile_walk_kernel" in name:
        return True
    if "tile_fill_kernel<" not in name:
        return False
    args = name.split("tile_fill_kernel<", 1)[1].split(">", 1)[0]
    return args.split(",")[1].strip() == "false"  # kBand


def read(run):
    launches = run.kernel_calls["profile_dp"]
    spent = run.device_s(_is_profile_kernel)
    if not launches or not spent:
        return None
    return 100.0 * sum(roofline.profile_bound_s(s) for s in launches) / spent
