"""XCF — the StreamBlocks configuration file (paper §III-A, Listing 2).

Maps actor instances to partitions (host threads / device sub-meshes), selects
code generators, and pins FIFO depths.  Stored as JSON (the paper uses XML; an
XML export is provided for fidelity).  The partitioner emits XCFs; both runtimes
consume them — partitioning is configuration, never a code change.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional


@dataclass
class PartitionSpec:
    id: str
    pe: str  # processing element, e.g. "x86_64" or "tpu-v5e-16x16"
    code_generator: str  # "sw" | "hw"
    instances: List[str] = field(default_factory=list)


@dataclass
class ConnectionSpec:
    source: str
    source_port: str
    target: str
    target_port: str
    size: Optional[int] = None  # FIFO depth; None lets the code generator choose


@dataclass
class XCF:
    network: str
    partitions: Dict[str, PartitionSpec] = field(default_factory=dict)
    connections: List[ConnectionSpec] = field(default_factory=list)
    code_generators: Dict[str, str] = field(
        default_factory=lambda: {"sw": "multicore", "hw": "jax-spmd"}
    )
    meta: Dict[str, float] = field(default_factory=dict)  # e.g. predicted T_exec

    # ------------------------------------------------------------------ api --
    def assignment(self) -> Dict[str, str]:
        """actor instance -> partition id."""
        out = {}
        for pid, p in self.partitions.items():
            for a in p.instances:
                out[a] = pid
        return out

    def fifo_depths(self) -> Dict[tuple, int]:
        return {
            (c.source, c.source_port, c.target, c.target_port): c.size
            for c in self.connections
            if c.size is not None
        }

    def validate(self, graph) -> None:
        seen = set()
        for pid, p in self.partitions.items():
            for a in p.instances:
                assert a in graph.actors, f"XCF: unknown actor {a}"
                assert a not in seen, f"XCF: {a} in multiple partitions"
                seen.add(a)
                actor = graph.actors[a]
                if p.code_generator == "hw":
                    assert actor.device_ok, (
                        f"XCF: {a} cannot be placed on hardware: "
                        f"{actor.host_only_reason}"
                    )
        missing = set(graph.actors) - seen
        assert not missing, f"XCF: unassigned actors {sorted(missing)}"

    # --------------------------------------------------------------- persist --
    def to_json(self) -> str:
        return json.dumps(
            {
                "network": self.network,
                "partitions": {k: asdict(v) for k, v in self.partitions.items()},
                "connections": [asdict(c) for c in self.connections],
                "code_generators": self.code_generators,
                "meta": self.meta,
            },
            indent=1,
        )

    @classmethod
    def from_json(cls, text: str) -> "XCF":
        d = json.loads(text)
        return cls(
            network=d["network"],
            partitions={
                k: PartitionSpec(**v) for k, v in d["partitions"].items()
            },
            connections=[ConnectionSpec(**c) for c in d["connections"]],
            code_generators=d.get("code_generators", {}),
            meta=d.get("meta", {}),
        )

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "XCF":
        return cls.from_json(Path(path).read_text())

    def to_xml(self) -> str:
        """Paper Listing 2 format."""
        root = ET.Element("configuration")
        ET.SubElement(root, "network", id=self.network)
        part = ET.SubElement(root, "partitioning")
        for pid, p in self.partitions.items():
            pe = ET.SubElement(
                part, "partition", id=pid, pe=p.pe,
                attrib={"code-generator": p.code_generator},
            )
            for a in p.instances:
                ET.SubElement(pe, "instance", id=a)
        cgs = ET.SubElement(root, "code-generators")
        for cid, plat in self.code_generators.items():
            ET.SubElement(cgs, "code-generator", id=cid, platform=plat)
        conns = ET.SubElement(root, "connections")
        for c in self.connections:
            attrib = {
                "source": c.source, "source-port": c.source_port,
                "target": c.target, "target-port": c.target_port,
            }
            if c.size is not None:
                attrib["size"] = str(c.size)
            ET.SubElement(conns, "fifo-connection", attrib=attrib)
        ET.indent(root)
        return ET.tostring(root, encoding="unicode", xml_declaration=True)


def make_xcf(
    network: str,
    assignment: Dict[str, str],
    *,
    accel="accel",  # str | Iterable[str]: partition id(s) that are hw
    accel_pe: str = "tpu-v5e-16x16",
    host_pe: str = "x86_64",
    depths: Optional[Dict[tuple, int]] = None,
    meta: Optional[Dict[str, float]] = None,
) -> XCF:
    accels = {accel} if isinstance(accel, str) else set(accel)
    xcf = XCF(network=network, meta=dict(meta or {}))
    for a, pid in sorted(assignment.items()):
        if pid not in xcf.partitions:
            hw = pid in accels
            xcf.partitions[pid] = PartitionSpec(
                id=pid,
                pe=accel_pe if hw else host_pe,
                code_generator="hw" if hw else "sw",
            )
        xcf.partitions[pid].instances.append(a)
    for (s, sp, t, tp), size in (depths or {}).items():
        xcf.connections.append(ConnectionSpec(s, sp, t, tp, size))
    return xcf
