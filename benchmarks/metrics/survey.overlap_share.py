"""``survey.overlap_share``: the share of the survey's chunks that kernel B6
ran beside an earlier chunk of the same call, on another stream, in %:
``overlapped`` over ``chunks``, both counted by the program over the run's
process (``inflatox_torch.background.survey_counts``, counted always, read
once after the window).  0 where every call is one chunk; a program
without the counter, or one that enqueued no chunk on the card, reads
nothing."""


def read(view):
    try:
        from inflatox_torch.background import survey_counts
    except ImportError:  # a program without the counter
        return None
    counts = survey_counts()
    if not counts["chunks"]:
        return None
    return 100.0 * counts["overlapped"] / counts["chunks"]
