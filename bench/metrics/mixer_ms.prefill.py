"""Device ms a traced prefill request credits to the program span
``mixer`` (self time): every block's attention or SSM mixer with its
projections (``model/blocks.py::block_mixer``)."""

from bench.harness.readers import span_ms


def read(run):
    return span_ms(run, "mixer")
