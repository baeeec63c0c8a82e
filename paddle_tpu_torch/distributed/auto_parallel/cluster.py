"""Cluster — the port of ``paddle_tpu/distributed/auto_parallel/cluster.py``:
the machine the planner plans for, as (device kind) x (hosts) x (chips a
host) and two link classes, with the reference's JSON.

The reference's two link classes are a TPU pod's: ICI inside a slice,
DCN between hosts. The port keeps the keys, so that ``axis_medium`` and
the mapper answer alike, and reads them for a GPU cluster as: ``ici``
the links inside a node (NVLink on an H100 node), ``dcn`` the network
between nodes. Every reference row of ``DEVICE_SPECS`` is kept and an
``"h100"`` row is added; a reference-schema JSON whose device type names
an H100 maps to it.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from .cost_model import ClusterSpec

# Per-chip hardware table (public numbers; bf16 peak, HBM size/bandwidth,
# per-direction ICI link bandwidth). "cpu-test" models the 8-device virtual
# CPU mesh used by the test tier: collectives are memcpys, so ICI is set to
# host-memory-copy scale and DCN==ICI (no host boundary exists).
DEVICE_SPECS: dict[str, dict] = {
    "v5e": dict(peak_flops=197e12, hbm_bytes=16e9, hbm_bandwidth=819e9,
                ici_bandwidth=45e9, ici_latency=1e-6),
    "v5p": dict(peak_flops=459e12, hbm_bytes=95e9, hbm_bandwidth=2.76e12,
                ici_bandwidth=90e9, ici_latency=1e-6),
    "v4": dict(peak_flops=275e12, hbm_bytes=32e9, hbm_bandwidth=1.2e12,
               ici_bandwidth=50e9, ici_latency=1e-6),
    "v6e": dict(peak_flops=918e12, hbm_bytes=32e9, hbm_bandwidth=1.6e12,
                ici_bandwidth=90e9, ici_latency=1e-6),
    # NVIDIA H100 SXM5 data sheet (nvidia.com, "NVIDIA H100 Tensor Core
    # GPU" datasheet): dense BF16 tensor-core peak 989 TFLOP/s, 80 GB HBM3
    # at 3.35 TB/s, NVLink 900 GB/s (450 GB/s each direction). Published
    # figures, not measurements; the latency is the other rows' 1 us.
    "h100": dict(peak_flops=989e12, hbm_bytes=80e9, hbm_bandwidth=3.35e12,
                 ici_bandwidth=450e9, ici_latency=1e-6),
    "cpu-test": dict(peak_flops=2e11, hbm_bytes=4e9, hbm_bandwidth=30e9,
                     ici_bandwidth=10e9, ici_latency=2e-6),
}


@dataclass
class Cluster:
    """hosts x chips_per_host of one device kind, ICI within a host's slice,
    DCN across hosts. `accelerator_type` keys DEVICE_SPECS; overrides let a
    JSON pin measured numbers."""

    accelerator_type: str = "v5p"
    n_hosts: int = 1
    chips_per_host: int = 8
    dcn_bandwidth: float = 25e9  # bytes/s per host NIC
    dcn_latency: float = 10e-6
    overrides: dict = field(default_factory=dict)

    # ------------------------------------------------------------ derived
    @property
    def n_chips(self) -> int:
        return self.n_hosts * self.chips_per_host

    def device(self, key: str) -> float:
        spec = dict(DEVICE_SPECS[self.accelerator_type])
        spec.update(self.overrides)
        return spec[key]

    def host_of(self, rank: int) -> int:
        return rank // self.chips_per_host

    def same_host(self, a: int, b: int) -> bool:
        return self.host_of(a) == self.host_of(b)

    def bandwidth(self, a: int, b: int) -> float:
        """Point-to-point bandwidth between two ranks: ICI inside a host's
        slice, the host NIC's DCN share across hosts."""
        if a == b:
            return self.device("hbm_bandwidth")
        return self.device("ici_bandwidth") if self.same_host(a, b) \
            else self.dcn_bandwidth / self.chips_per_host

    def axis_medium(self, group_size: int, stride: int = 1,
                    groups=None) -> str:
        """Medium a collective over `group_size` ranks spaced `stride` apart
        rides on: 'ici' when EVERY such group lives inside one host.

        `groups` (iterable of rank iterables) checks the mapper's actual
        groups; otherwise the strided tiling of the whole cluster is
        enumerated. Checking real ranks via host_of matters when
        chips_per_host is not a power of two: size 2 stride 2 on a 6-chip
        host has span 4 <= 6, but the group {4, 6} straddles a host
        boundary."""
        if groups is None:
            groups = (
                [base + i * stride for i in range(group_size)]
                for base in range(self.n_chips)
                if (base // stride) % group_size == 0
                and base + (group_size - 1) * stride < self.n_chips)
        checked = False
        for g in groups:
            checked = True
            hosts = {self.host_of(int(r)) for r in g}
            if len(hosts) > 1:
                return "dcn"
        # no group at all (e.g. group_size * stride overruns the cluster):
        # fail CLOSED — claiming 'ici' would cost-model a cross-host
        # collective at on-chip bandwidth
        return "ici" if checked else "dcn"

    def to_cluster_spec(self) -> ClusterSpec:
        """Flatten into the alpha-beta cost model's constants."""
        return ClusterSpec(
            chips=self.n_chips,
            peak_flops=self.device("peak_flops"),
            hbm_bytes=self.device("hbm_bytes"),
            hbm_bandwidth=self.device("hbm_bandwidth"),
            ici_bandwidth=self.device("ici_bandwidth"),
            dcn_bandwidth=self.dcn_bandwidth,
            ici_latency=self.device("ici_latency"),
            dcn_latency=self.dcn_latency,
        )

    # --------------------------------------------------------------- json
    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Cluster":
        d = json.loads(s)
        # reference-schema tolerance: cluster.py JSONs nest under "machines"
        if "machines" in d:
            machines = d["machines"]
            dev = machines[0].get("devices", [])
            kind = (dev[0].get("type", "v5p") if dev else "v5p").lower()
            if "h100" in kind:
                kind = "h100"
            if kind not in DEVICE_SPECS:
                kind = "v5p"
            return cls(accelerator_type=kind, n_hosts=len(machines),
                       chips_per_host=max(len(dev), 1))
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_file(cls, path: str) -> "Cluster":
        with open(path) as f:
            return cls.from_json(f.read())


def cpu_test_cluster(n_devices: int = 8) -> Cluster:
    """The virtual CPU mesh the test tier runs on: one 'host', memcpy links."""
    return Cluster(accelerator_type="cpu-test", n_hosts=1,
                   chips_per_host=n_devices)
