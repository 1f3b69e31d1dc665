"""``ang.b6.lane_share``: the share of kernel B6's lanes doing work in the
cell ``angular.survey``, in %: the attempts of every trajectory over the
lanes' attempts (each warp's most attempts times its lanes that hold a
trajectory), both counted by the program on the card over the traced calls
(``inflatox_torch.ops.cuda_solver.attempt_counts``, read once after the
window; the program counts only while a profiler records).  Below 100 %
the lanes of a warp wait for the one that needs most attempts."""


def read(view):
    try:
        from inflatox_torch.ops.cuda_solver import attempt_counts
    except ImportError:  # a program without the counter
        return None
    counts = attempt_counts()
    if not counts["lane_attempts"]:
        return None
    return 100.0 * counts["attempts"] / counts["lane_attempts"]
