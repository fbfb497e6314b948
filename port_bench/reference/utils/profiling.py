"""Pass labels: `pass_scope(name)`, a `torch.profiler.record_function`
range, as the port labels its passes."""

from torch.profiler import record_function


def pass_scope(name: str):
    """Label a render/sim pass in profiler traces."""
    return record_function(name)
