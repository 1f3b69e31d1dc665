"""``survey.reduce_ms``: the host time of the survey's reduction, in ms a
call: the program's ``inflx.survey.reduce`` spans (``_survey_reduce``'s
torch operations put on the device) over the traced calls."""

from spans import ms_per_call


def read(view):
    return ms_per_call(view, "inflx.survey.reduce")
