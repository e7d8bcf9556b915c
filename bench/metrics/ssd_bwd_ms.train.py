"""Device ms a traced training step credits to the program span
``ssd.backward`` (self time): the SSD scan's plain-vjp backward
(``model/ssm.py::SSDScan.backward``)."""

from bench.harness.readers import span_ms


def read(run):
    return span_ms(run, "ssd.backward")
