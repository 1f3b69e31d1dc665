"""``setup.load_s``: seconds of the set-up spent loading the model (the
bundle's ``CompiledModel.load``, or its sympy build on a checkout's first
run) and making ``GeneralisedAL``: the benchmark's span around them."""


def read(view):
    return view.setup.get("load_s")
