"""The whole step's share of the card's peak (%): the model FLOPs of every
cell-step the window computed, over the trace's window and the card's
published peak at the traffic's precision (float32 on the CUDA cores with
TF32 off, or bf16 on the tensor cores).

The programs compute every cell's step on every tick and let the market
gate the update afterwards, so every cell-step is model work done, and the
count (ticks × cells) does not move with the market's draws. One
cell-step's FLOPs are the configuration reference's ``step_flops`` at the
traffic's batch and ``seq_len − 1`` positions; a configuration whose
reference does not count them reads nothing."""


def read(facts):
    peaks, t, ref = facts.get("peaks"), facts["traffic"], facts["reference"]
    window = facts.get("trace_window_s")
    if peaks is None or not window or not facts.get("cell_steps") \
            or not hasattr(ref, "step_flops"):
        return None
    flops = ref.step_flops(facts["conf"], t["batch"], t["seq_len"] - 1) \
        * facts["cell_steps"]
    return 100.0 * flops / window / peaks.flops(t["dtype"])
