"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their plain
PyTorch versions (``ref``) and the wrappers that dispatch between them by
device (``ops``). Kernels are built and loaded at first launch
(``build``), never at import."""
import threading

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches``: its kernel was launched ``n``
    times. Under a lock, since shards on different cards launch from their
    own host threads (`sim.engine.simulate_sharded`)."""
    with _COUNT_LOCK:
        wrapper.launches += n
