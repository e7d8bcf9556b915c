"""Device ms a traced training step credits to the program spans ``loss``
and ``head.backward`` (self time): the chunked cross-entropy with its
recompute (``model/lm.py::_ce_chunk``) and the LM head's float32 backward
(``_HeadF32.backward``)."""

from bench.harness.readers import span_ms


def read(run):
    return span_ms(run, "loss", "head.backward")
