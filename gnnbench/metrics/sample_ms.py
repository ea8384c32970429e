"""The device milliseconds a step under the program's span sampler.device
(``trainer.sample_layers``: the in-step sampler of --mode puregpu), in the
traced units that ``gnnbench/spans.py`` runs after the profiled slice.
This is the sampler's interval on the stream, from its start event to its
end event: its kernels and the launch bubbles between them, so it moves
with the host's launch speed too.  ``device_sample_ms`` sums the kernels
alone."""

from gnnbench import spans
from gnnbench.spans import install  # noqa: F401


def read(ctx):
    return spans.device_ms(ctx, "sampler.device")
