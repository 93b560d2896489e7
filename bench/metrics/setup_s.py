"""Set-up time (s): from the start of the process until the window opens,
on the host's clock: imports, the program, the weights and the set-up
ticks that build and warm every kernel."""


def read(facts):
    return facts.get("setup_s")
