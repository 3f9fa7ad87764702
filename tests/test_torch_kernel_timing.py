"""``kernel_timing``'s hook on the CPU: the entry points it hands out pass
their ctypes attributes and calls through, and a call that returns non-zero
(a size, an error: no launch) is never repeated."""

import ctypes
import ctypes.util
import types

import kernel_timing


def test_hooked_entry_points_pass_through_and_repeat_no_non_launch():
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    build = types.SimpleNamespace(load=lambda name: libc)
    kernel_timing.hook(build)
    labs = build.load("c").labs
    labs.argtypes = [ctypes.c_long]
    labs.restype = ctypes.c_long
    assert libc.labs.argtypes == [ctypes.c_long] and libc.labs.restype is ctypes.c_long
    assert labs(-7) == 7
    assert kernel_timing.own_ms(lambda: labs(-3)) == (0, 0)
    assert kernel_timing._replays is None


def test_k1_floor_source_returns_after_the_keypoint_loads():
    """The floor variant of K1 keeps the loads and the stores and nothing
    after them."""
    from instance_segmentation_torch.kernels import build
    src = (build.CSRC / "affinity.cu").read_text()
    floor = kernel_timing.k1_floor_source(src)
    head, _, rest = floor.partition(kernel_timing.K1_STAGING)
    assert "s = sig[p];" in head and head.rstrip().endswith("return;")
    assert head.count("best[p] =") == 1 and rest == src.partition(kernel_timing.K1_STAGING)[2]
