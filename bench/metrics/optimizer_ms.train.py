"""Device ms a traced training step credits to the program span
``train.optimizer`` (self time): the AdamW update (``launch/steps.py``
around ``optim/adamw.py::adamw_update``)."""

from bench.harness.readers import span_ms


def read(run):
    return span_ms(run, "train.optimizer")
