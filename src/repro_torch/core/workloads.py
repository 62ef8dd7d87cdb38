"""Workload models: the six CNNs of the paper's evaluation (Fig. 4 / Fig. 6)
plus a generic GEMM workload hook for the assigned LM architectures.

Each workload is a list of layers with MAC counts, operand byte counts, and
dot-product lengths (the quantity that determines photonic MAC-unit vector
utilization in 2.5D-CrossLight's heterogeneous chiplets).

Interposer traffic model (Sec. V): every layer reads weights + input
activations from the memory chiplet GLB (SWMR broadcast to compute chiplets)
and writes output activations back (SWSR).  8-bit operands, matching the
CrossLight line of work (noncoherent photonic accelerators quantize to <=8b).

The port's copy of the JAX package's `core/workloads.py` (plain Python).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.core.power import Traffic


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    macs: float
    weight_bytes: float
    in_bytes: float
    out_bytes: float
    dot_length: int      # length of each dot product (R*S*C or fan-in)
    n_dots: float        # number of dot products (K * Hout * Wout or fan-out)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    layers: List[Layer]

    @property
    def total_macs(self) -> float:
        return sum(l.macs for l in self.layers)

    def traffic(self, transfers_per_layer: int = 16) -> Traffic:
        return Traffic(
            bytes_read=sum(l.weight_bytes + l.in_bytes for l in self.layers),
            bytes_written=sum(l.out_bytes for l in self.layers),
            n_transfers=transfers_per_layer * len(self.layers),
        )


DTYPE_BYTES = 1  # 8-bit operands


def _conv(name, cin, cout, k, stride, hin, groups=1) -> tuple[Layer, int]:
    hout = max(1, hin // stride)
    macs = (cout * cin // groups) * k * k * hout * hout
    w = (cout * cin // groups) * k * k * DTYPE_BYTES
    i = cin * hin * hin * DTYPE_BYTES
    o = cout * hout * hout * DTYPE_BYTES
    dot = (cin // groups) * k * k
    return Layer(name, macs, w, i, o, dot, cout * hout * hout), hout


def _fc(name, fin, fout) -> Layer:
    return Layer(name, fin * fout, fin * fout * DTYPE_BYTES,
                 fin * DTYPE_BYTES, fout * DTYPE_BYTES, fin, fout)


def lenet5() -> Workload:
    ls: List[Layer] = []
    l, h = _conv("c1", 1, 6, 5, 1, 32); ls.append(l); h //= 2
    l, h = _conv("c2", 6, 16, 5, 1, h); ls.append(l); h //= 2
    ls += [_fc("f1", 16 * 5 * 5, 120), _fc("f2", 120, 84), _fc("f3", 84, 10)]
    return Workload("LeNet5", ls)


def vgg16() -> Workload:
    ls: List[Layer] = []
    h, cin = 224, 3
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    for i, c in enumerate(cfg):
        if c == "M":
            h //= 2
            continue
        l, h = _conv(f"c{i}", cin, c, 3, 1, h)
        ls.append(l)
        cin = c
    ls += [_fc("f1", 512 * 7 * 7, 4096), _fc("f2", 4096, 4096), _fc("f3", 4096, 1000)]
    return Workload("VGG16", ls)


def resnet18() -> Workload:
    ls: List[Layer] = []
    l, h = _conv("stem", 3, 64, 7, 2, 224); ls.append(l); h //= 2  # maxpool
    cin = 64
    for si, (c, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
        for b in range(2):
            st = s if b == 0 else 1
            l, h2 = _conv(f"s{si}b{b}a", cin, c, 3, st, h); ls.append(l)
            l, _ = _conv(f"s{si}b{b}b", c, c, 3, 1, h2); ls.append(l)
            if st != 1 or cin != c:
                l, _ = _conv(f"s{si}b{b}d", cin, c, 1, st, h); ls.append(l)
            h, cin = h2, c
    ls.append(_fc("fc", 512, 1000))
    return Workload("ResNet18", ls)


def mobilenet_v2() -> Workload:
    ls: List[Layer] = []
    l, h = _conv("stem", 3, 32, 3, 2, 224); ls.append(l)
    cin = 32
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for bi, (t, c, n, s) in enumerate(cfg):
        for i in range(n):
            st = s if i == 0 else 1
            mid = cin * t
            if t != 1:
                l, _ = _conv(f"b{bi}.{i}.e", cin, mid, 1, 1, h); ls.append(l)
            l, h2 = _conv(f"b{bi}.{i}.d", mid, mid, 3, st, h, groups=mid); ls.append(l)
            l, _ = _conv(f"b{bi}.{i}.p", mid, c, 1, 1, h2); ls.append(l)
            h, cin = h2, c
    l, _ = _conv("head", cin, 1280, 1, 1, h); ls.append(l)
    ls.append(_fc("fc", 1280, 1000))
    return Workload("MobileNetV2", ls)


def efficientnet_b0() -> Workload:
    ls: List[Layer] = []
    l, h = _conv("stem", 3, 32, 3, 2, 224); ls.append(l)
    cin = 32
    cfg = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
           (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]
    for bi, (t, c, n, s, k) in enumerate(cfg):
        for i in range(n):
            st = s if i == 0 else 1
            mid = cin * t
            if t != 1:
                l, _ = _conv(f"b{bi}.{i}.e", cin, mid, 1, 1, h); ls.append(l)
            l, h2 = _conv(f"b{bi}.{i}.d", mid, mid, k, st, h, groups=mid); ls.append(l)
            l, _ = _conv(f"b{bi}.{i}.p", mid, c, 1, 1, h2); ls.append(l)
            h, cin = h2, c
    l, _ = _conv("head", cin, 1280, 1, 1, h); ls.append(l)
    ls.append(_fc("fc", 1280, 1000))
    return Workload("EfficientNetB0", ls)


def densenet121() -> Workload:
    ls: List[Layer] = []
    growth = 32
    l, h = _conv("stem", 3, 64, 7, 2, 224); ls.append(l); h //= 2
    cin = 64
    for bi, n in enumerate([6, 12, 24, 16]):
        for i in range(n):
            l, _ = _conv(f"d{bi}.{i}.1", cin, 4 * growth, 1, 1, h); ls.append(l)
            l, _ = _conv(f"d{bi}.{i}.3", 4 * growth, growth, 3, 1, h); ls.append(l)
            cin += growth
        if bi < 3:
            l, _ = _conv(f"t{bi}", cin, cin // 2, 1, 1, h); ls.append(l)
            cin //= 2
            h //= 2
    ls.append(_fc("fc", cin, 1000))
    return Workload("DenseNet121", ls)


def gemm_workload(name: str, gemms: List[tuple[int, int, int]],
                  dtype_bytes: int = 2) -> Workload:
    """Generic GEMM workload (M, K, N per layer) — used to map the assigned LM
    architectures onto the 2.5D-CrossLight accelerator model (beyond-paper)."""
    ls = []
    for i, (m, k, n) in enumerate(gemms):
        ls.append(Layer(f"{name}.g{i}", float(m) * k * n,
                        k * n * dtype_bytes, m * k * dtype_bytes,
                        m * n * dtype_bytes, k, float(m) * n))
    return Workload(name, ls)


CNN_WORKLOADS: Dict[str, Callable[[], Workload]] = {
    "DenseNet121": densenet121,
    "ResNet18": resnet18,
    "LeNet5": lenet5,
    "VGG16": vgg16,
    "MobileNetV2": mobilenet_v2,
    "EfficientNetB0": efficientnet_b0,
}
