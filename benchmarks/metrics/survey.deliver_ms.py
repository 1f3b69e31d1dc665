"""``survey.deliver_ms``: the survey's delivery to numpy, in ms a call: the
program's ``inflx.survey.deliver`` spans (the five summaries' copies to
the host, which wait for kernel B6 and the reduction) over the traced
calls."""

from spans import ms_per_call


def read(view):
    return ms_per_call(view, "inflx.survey.deliver")
