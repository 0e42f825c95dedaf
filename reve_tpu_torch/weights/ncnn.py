"""Parser for ncnn .param/.bin model files -> the port's SRVGG params.

Counterpart of reve_tpu/weights/ncnn.py (numpy, copied; only `to_params`
differs: it gives the port's params as float32 torch tensors).  The
reference ships its models in exactly this format: the release zip
bundles `realesr-animevideov3-x{2,3,4}.param/.bin` next to the
`realesrgan-ncnn-vulkan` binary it spawns (reve-shared/src/lib.rs:140-143
selects the model by name).  This module lets those same files load
directly into the engine, with no torch checkpoint needed.  Like the
reference's, it reads SRVGG graphs only.

Format notes (ncnn model format, reverse-engineered from public docs):

.param (text):
    7767517                         <- magic
    <layer_count> <blob_count>
    <LayerType> <name> <#in> <#out> <in blobs...> <out blobs...> <k>=<v>...
  Array params use key id < -23300 ("-233xx"); value is "len,v1,v2,...".
  Convolution params: 0=num_output 1=kernel_w 11=kernel_h 2=dilation
  3=stride 4=pad 5=bias_term 6=weight_data_size.  PReLU: 0=num_slope.

.bin (binary), in .param layer order:
  * Convolution: weight blob with a 4-byte tag:
      0x00000000 -> raw float32
      0x01306B47 -> float16 (2 bytes/elt, padded to 4-byte alignment),
                    widened to float32 exactly (np.float16 -> float32)
      0x0002C056 -> raw float32 (alternate tag)
      any other nonzero tag -> uint8 with a 1024-byte (256 x f32) quant table
    followed (if bias_term) by the bias as raw float32, no tag.
    Weight element order is OIHW flattened.
  * PReLU: num_slope raw float32, no tag.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = "7767517"
_TAG_F32_ALT = 0x0002C056
_TAG_F16 = 0x01306B47
_TAG_I8 = 0x000D4B38


@dataclasses.dataclass
class NcnnLayer:
    type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    params: Dict[int, object]

    def p(self, key: int, default=None):
        return self.params.get(key, default)


def parse_param(text: str) -> List[NcnnLayer]:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if lines[0] != _MAGIC:
        raise ValueError(f"bad ncnn .param magic: {lines[0]!r}")
    layer_count, _blob_count = (int(t) for t in lines[1].split())
    layers: List[NcnnLayer] = []
    for ln in lines[2:2 + layer_count]:
        toks = ln.split()
        ltype, name, nin, nout = toks[0], toks[1], int(toks[2]), int(toks[3])
        ins = toks[4:4 + nin]
        outs = toks[4 + nin:4 + nin + nout]
        params: Dict[int, object] = {}
        for kv in toks[4 + nin + nout:]:
            k, v = kv.split("=", 1)
            k = int(k)
            if k <= -23300:
                idx = -k - 23300
                parts = v.split(",")
                vals = [float(x) if ("." in x or "e" in x) else int(x)
                        for x in parts[1:]]
                params[idx] = vals
            else:
                params[k] = float(v) if ("." in v or "e" in v) else int(v)
        layers.append(NcnnLayer(ltype, name, ins, outs, params))
    return layers


class _BinReader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError(
                f"ncnn .bin truncated: need {n} bytes at offset {self.off}, "
                f"have {len(self.data)}"
            )
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def load_raw_f32(self, count: int) -> np.ndarray:
        return np.frombuffer(self._take(4 * count), dtype="<f4").copy()

    def load_tagged(self, count: int) -> np.ndarray:
        (tag,) = struct.unpack("<I", self._take(4))
        if tag == 0 or tag == _TAG_F32_ALT:
            return self.load_raw_f32(count)
        if tag == _TAG_F16:
            arr = np.frombuffer(self._take(2 * count), dtype="<f2")
            if (2 * count) % 4:
                self._take(4 - (2 * count) % 4)  # align to 4 bytes
            return arr.astype(np.float32)
        if tag == _TAG_I8:
            raise NotImplementedError("ncnn int8 models are not supported")
        # quantized u8 with 256-entry f32 table
        table = np.frombuffer(self._take(1024), dtype="<f4")
        idx = np.frombuffer(self._take(count), dtype=np.uint8)
        if count % 4:
            self._take(4 - count % 4)
        return table[idx].astype(np.float32)


@dataclasses.dataclass
class NcnnSRVGG:
    """Extracted SRVGG-shaped weights + inferred hyper-parameters."""

    convs: List[Tuple[np.ndarray, Optional[np.ndarray]]]  # (HWIO weight, bias)
    prelus: List[np.ndarray]
    upscale: int
    num_feat: int
    num_conv: int


def load_srvgg(param_text: str, bin_data: bytes,
               num_out_ch: int = 3) -> NcnnSRVGG:
    """Walk the layer graph, pulling Convolution/PReLU weights in order."""
    layers = parse_param(param_text)
    reader = _BinReader(bin_data)
    convs: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
    prelus: List[np.ndarray] = []
    prev_out = None
    for layer in layers:
        if layer.type == "Convolution":
            num_output = int(layer.p(0, 0))
            kw = int(layer.p(1, 1))
            kh = int(layer.p(11, kw))
            bias_term = int(layer.p(5, 0))
            wsize = int(layer.p(6, 0))
            cin = wsize // (num_output * kw * kh)
            w = reader.load_tagged(wsize).reshape(num_output, cin, kh, kw)
            w = np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO
            b = reader.load_raw_f32(num_output) if bias_term else None
            convs.append((np.ascontiguousarray(w), b))
            prev_out = num_output
        elif layer.type == "PReLU":
            nslope = int(layer.p(0, prev_out or 0))
            prelus.append(reader.load_raw_f32(nslope))
    if len(convs) < 2:
        raise ValueError(f"not an SRVGG graph: only {len(convs)} convs found")
    last_out = convs[-1][0].shape[-1]
    upscale_sq = last_out // num_out_ch
    upscale = int(round(upscale_sq ** 0.5))
    if upscale * upscale * num_out_ch != last_out:
        raise ValueError(
            f"last conv has {last_out} outputs; not num_out_ch*r^2 for any r"
        )
    return NcnnSRVGG(
        convs=convs,
        prelus=prelus,
        upscale=upscale,
        num_feat=convs[0][0].shape[-1],
        num_conv=len(convs) - 2,
    )


def to_params(net: NcnnSRVGG):
    """NcnnSRVGG -> (SRVGGConfig, params) for reve_tpu_torch.models.srvgg,
    params as float32 CPU tensors (HWIO `w`, `b`, `alpha`)."""
    import torch

    from reve_tpu_torch.models.srvgg import SRVGGConfig

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    cfg = SRVGGConfig(
        num_in_ch=net.convs[0][0].shape[2],
        num_out_ch=net.convs[-1][0].shape[-1] // (net.upscale ** 2),
        num_feat=net.num_feat,
        num_conv=net.num_conv,
        upscale=net.upscale,
    )
    params = {"convs": [], "prelus": []}
    for w, b in net.convs:
        if b is None:
            b = np.zeros((w.shape[-1],), np.float32)
        params["convs"].append({"w": t(w), "b": t(b)})
    for alpha in net.prelus:
        params["prelus"].append({"alpha": t(alpha)})
    return cfg, params


def load_files(param_path: str, bin_path: str):
    """Load .param/.bin files -> (SRVGGConfig, params)."""
    with open(param_path, "r") as f:
        param_text = f.read()
    with open(bin_path, "rb") as f:
        bin_data = f.read()
    return to_params(load_srvgg(param_text, bin_data))
