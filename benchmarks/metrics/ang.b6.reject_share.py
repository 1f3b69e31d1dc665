"""``ang.b6.reject_share``: the share of kernel B6's attempts that its step
control rejected in the cell ``angular.survey``, in %: the rejected
attempts over all attempts, both counted by the program on the card over
the traced calls (``inflatox_torch.ops.cuda_solver.attempt_counts``, read
once after the window; the program counts only while a profiler records).
With ``ang.b6.lane_share`` it tells lanes that wait for each other from
lanes that all reject more."""


def read(view):
    try:
        from inflatox_torch.ops.cuda_solver import attempt_counts
    except ImportError:  # a program without the counter
        return None
    counts = attempt_counts()
    if "rejects" not in counts or not counts["attempts"]:  # no rejection counter
        return None
    return 100.0 * counts["rejects"] / counts["attempts"]
