"""STE-GAN's three networks in plain PyTorch (Scheck et al., INTERSPEECH
2023; the silent-speech transduction encoder of Gaddy & Klein, 2021).

* ``Generator``: GanTTS stack. A 1x1 conv from speech features plus a
  64-wide session embedding to 768 channels, eight GBlocks (dilations 1/3
  and 9/27, nearest upsampling x2 in blocks 3-6 for speech units), ReLU, a
  k3 conv to 8 channels and tanh. Every conv is weight-normalised.
* ``Discriminator``: five period discriminators (2, 3, 5, 7, 11; (k, 1)
  convs over the folded signal) and three scale discriminators (grouped 1-D
  convs, average pooling 4/2/1 between scales; the first spectrally
  normalised with one power iteration per training forward). LeakyReLU 0.1;
  each returns its feature maps with the logits last.
* ``Encoder``: four stride-2 BatchNorm ResBlocks, a linear projection, six
  post-norm transformer layers with learned relative-position logits
  (clipped at 100 frames) and dropout, and linear unit and phoneme heads.

Parameters and buffers carry the names of the published state dicts, so
one seeded state dict loads into these modules and into any other
implementation that keeps those names. Tensors are channel-last at the
module boundary (``[B, T, C]``). Every convolution and product rounds as
the :class:`~portbench.reference.precision.Precision` it is given says;
normalisation statistics, softmax and losses stay in f32; the encoder's
linear layers and attention round as its ``mm()`` says.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.precision import F32, Precision

SMALL_PERIOD_SPEC = ((32, 3, 1, 2), (256, 3, 3, 2), (512, 3, 3, 2))
SMALL_SCALE_SPEC = ((128, 15, 1, 1, 7), (256, 37, 2, 4, 18),
                    (512, 37, 2, 16, 18), (1024, 5, 1, 1, 2))
PERIODS = (2, 3, 5, 7, 11)
LEAKY = 0.1
#: Soft speech-unit dimensions and the phoneme inventory's size.
UNIT_DIM, PHONEMES = 256, 48


def _norm_rows(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(v.float()),
                                dim=tuple(range(1, v.dim()))))


def _unit(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class _Conv(nn.Module):
    """A convolution's geometry; ``forward`` takes the effective weight."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 dilation=1, groups: int = 1, bias: bool = True):
        super().__init__()
        rank = 1 if isinstance(kernel, int) else len(kernel)

        def tup(v):
            return (v,) * rank if isinstance(v, int) else tuple(v)

        self.kernel, self.stride = tup(kernel), tup(stride)
        self.padding, self.dilation = tup(padding), tup(dilation)
        self.groups = groups
        self.wshape = (cout, cin // groups) + self.kernel
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def conv(self, x, w, p: Precision):
        fn = F.conv1d if len(self.kernel) == 1 else F.conv2d
        y = fn(p.operand(x), p.operand(w), None, self.stride, self.padding,
               self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view((1, -1) + (1,) * (y.dim() - 2))
        return y


class PlainConv(_Conv):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.weight = nn.Parameter(torch.empty(self.wshape))

    def forward(self, x, p: Precision = F32):
        return self.conv(x, self.weight, p)


class WNConv(_Conv):
    """``w = g * v / ||v||`` per output channel."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.weight_v = nn.Parameter(torch.empty(self.wshape))
        self.weight_g = nn.Parameter(
            torch.empty((self.wshape[0],) + (1,) * (len(self.wshape) - 1)))

    def weight(self):
        v = self.weight_v
        scale = self.weight_g.reshape(-1) / _norm_rows(v)
        return v * scale.view((-1,) + (1,) * (v.dim() - 1))

    def forward(self, x, p: Precision = F32):
        return self.conv(x, self.weight(), p)


class SNConv(_Conv):
    """Spectral norm with a persistent power iteration: a training forward
    takes one step ``v = unit(W^T u)``, ``u = unit(W v)`` (two with
    ``dual``: rows ``[:dual]`` over the first sigma, the rest over the
    second, as two forwards in turn would) and divides by ``u W v``."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.weight_orig = nn.Parameter(torch.empty(self.wshape))
        self.register_buffer("weight_u", torch.empty(self.wshape[0]))
        self.register_buffer("weight_v",
                             torch.empty(math.prod(self.wshape[1:])))

    def _step(self, mat, u):
        v = _unit(mat.T @ u)
        return _unit(mat @ v), v

    def forward(self, x, p: Precision = F32, dual: Optional[int] = None,
                train: bool = True):
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1).float()
        with torch.no_grad():
            u, v = self.weight_u.clone(), self.weight_v.clone()
            if train:
                u1, v1 = self._step(mat, u)
                u, v = (u1, v1) if dual is None else self._step(mat, u1)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        if dual is None or not train:
            return self.conv(x, w / (u @ (mat @ v)), p)
        bias, self.bias = self.bias, None
        y = self.conv(x, w, p)
        self.bias = bias
        inv = torch.cat([(1.0 / (u1 @ (mat @ v1))).expand(dual),
                         (1.0 / (u @ (mat @ v))).expand(y.shape[0] - dual)])
        y = y * inv.to(y.dtype).view(-1, 1, 1)
        return y + bias.to(y.dtype).view(1, -1, 1)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


def _same(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def gblock_spec(channels: int = 768, upsample_last: int = 2):
    ch = channels
    return ((ch, 1), (ch, 1), (ch // 2, 2), (ch // 2, 2), (ch // 2, 2),
            (ch // 4, upsample_last), (ch // 4, 1), (ch // 4, 1))


class GBlock(nn.Module):
    def __init__(self, cin: int, cout: int, up: int):
        super().__init__()
        self.up = up
        off = 1 if up > 1 else 0
        self.names = (str(1 + off), str(3 + off), str(off))
        self.conv1 = nn.ModuleDict({
            self.names[0]: WNConv(cin, cout, 3, padding=_same(3)),
            self.names[1]: WNConv(cout, cout, 3, padding=_same(3, 3),
                                  dilation=3)})
        self.res1 = nn.ModuleDict({self.names[2]: WNConv(cin, cout, 1)})
        self.conv2 = nn.ModuleDict({
            "1": WNConv(cout, cout, 3, padding=_same(3, 9), dilation=9),
            "3": WNConv(cout, cout, 3, padding=_same(3, 27), dilation=27)})

    def forward(self, x, p: Precision):
        a, b, r = self.names

        def upsample(t):
            return t if self.up == 1 else torch.repeat_interleave(t, self.up,
                                                                  dim=-1)

        h = self.conv1[a](upsample(F.relu(x)), p)
        h = self.conv1[b](F.relu(h), p)
        y = h + self.res1[r](upsample(x), p)
        h2 = self.conv2["1"](F.relu(y), p)
        h2 = self.conv2["3"](F.relu(h2), p)
        return y + h2


class Generator(nn.Module):
    """Speech units ``[B, T, 256]`` + session ``[B]`` -> EMG
    ``[B, 16 T, 8]`` in f32."""

    def __init__(self, feat_dim: int = UNIT_DIM, num_sessions: int = 17,
                 channels: int = 768, emb_dim: int = 64, out_ch: int = 8,
                 upsample_last: int = 2):
        super().__init__()
        self.session_embeddings = nn.Embedding(num_sessions, emb_dim)
        blocks: List[nn.Module] = [WNConv(feat_dim + emb_dim, channels, 1)]
        cur = channels
        for cout, up in gblock_spec(channels, upsample_last):
            blocks.append(GBlock(cur, cout, up))
            cur = cout
        self.gblocks = nn.ModuleList(blocks)
        self.last_conv = nn.ModuleDict({"1": WNConv(cur, out_ch, 3,
                                                    padding=1)})

    def forward(self, feats, session, p: Precision = F32):
        b, t, _ = feats.shape
        emb = self.session_embeddings(session.long())
        x = torch.cat([feats.to(p.dtype),
                       emb.to(p.dtype)[:, None].expand(b, t, emb.shape[-1])],
                      dim=-1).transpose(1, 2)
        x = self.gblocks[0](x, p)
        for block in self.gblocks[1:]:
            x = block(x, p)
        x = self.last_conv["1"](F.relu(x), p)
        return torch.tanh(x.float()).transpose(1, 2)


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


class PeriodDisc(nn.Module):
    def __init__(self, period: int, cin: int = 8,
                 spec: Sequence = SMALL_PERIOD_SPEC):
        super().__init__()
        self.period = period
        layers = []
        for feats, k, s, pad in spec:
            layers.append(WNConv(cin, feats, (k, 1), stride=(s, 1),
                                 padding=(pad, 0)))
            cin = feats
        self.layers = nn.ModuleList(layers)
        self.output = WNConv(cin, 1, (3, 1), padding=(1, 0))

    def forward(self, x, p: Precision, dual=None, train=True):
        per = self.period
        x = F.pad(x, (0, per - x.shape[-1] % per), mode="reflect")
        b, c, t = x.shape
        x = x.view(b, c, t // per, per)
        fmaps = []
        for layer in self.layers:
            x = F.leaky_relu(layer(x, p), LEAKY)
            fmaps.append(x)
        fmaps.append(self.output(x, p))
        return fmaps


class ScaleDisc(nn.Module):
    def __init__(self, spectral: bool, cin: int = 8,
                 spec: Sequence = SMALL_SCALE_SPEC):
        super().__init__()
        layers = []
        for feats, k, s, g, pad in spec:
            cls = SNConv if spectral else WNConv
            layers.append(cls(cin, feats, k, stride=s, padding=pad, groups=g))
            cin = feats
        self.layers = nn.ModuleList(layers)
        self.output = WNConv(cin, 1, 3, padding=1)

    def forward(self, x, p: Precision, dual=None, train=True):
        fmaps = []
        for layer in self.layers:
            if isinstance(layer, SNConv):
                x = layer(x, p, dual=dual, train=train)
            else:
                x = layer(x, p)
            x = F.leaky_relu(x, LEAKY)
            fmaps.append(x)
        fmaps.append(self.output(x, p))
        return fmaps


class Discriminator(nn.Module):
    """``forward(fake, real)`` evaluates both on one stacked batch (the
    spectral norm then steps twice) and returns their feature-map lists."""

    def __init__(self, cin: int = 8):
        super().__init__()
        self.multi_pooled_disc = nn.ModuleList(
            [PeriodDisc(per, cin) for per in PERIODS])
        self.multi_scale_disc = nn.ModuleList(
            [ScaleDisc(i == 0, cin) for i in range(3)])

    def forward(self, fake, real, p: Precision = F32, train: bool = True):
        b = fake.shape[0]
        x = torch.cat([fake.to(p.dtype), real.to(p.dtype)]).transpose(1, 2)
        out_fake, out_real = [], []

        def split(fmaps):
            out_fake.append([f[:b] for f in fmaps])
            out_real.append([f[b:] for f in fmaps])

        for disc in self.multi_pooled_disc:
            split(disc(x, p))
        for i, disc in enumerate(self.multi_scale_disc):
            split(disc(x, p, dual=b if i == 0 else None, train=train))
            x = F.avg_pool1d(x, 4, 2, 1, count_include_pad=True)
        return out_fake, out_real


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class MaskStream:
    """Dropout masks drawn in turn from one ``torch.Generator``: every
    mask is ``rand(shape) < keep``, so two streams seeded alike give the
    same masks for the same sequence of shapes."""

    def __init__(self, generator: torch.Generator, rate: float):
        self.generator, self.keep = generator, 1.0 - rate

    def __call__(self, x):
        draw = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(draw < self.keep, x / self.keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


def _identity(x):
    return x


def batch_norm(x, bn: nn.BatchNorm1d, train: bool):
    """Eval: the running statistics. Train: the biased batch variance over
    (batch, time), and the running statistics moved by 0.1 towards the
    batch mean and biased variance (flax's ``BatchNorm(momentum=0.9)``)."""
    xf = x.float()
    if not train:
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    var, mean = torch.var_mean(xf, dim=(0, 2), correction=0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(0.1 * mean.detach())
        bn.running_var.mul_(0.9).add_(0.1 * var.detach())
    return ((xf - mean[None, :, None]) * torch.rsqrt(var + bn.eps)[None, :, None]
            * bn.weight[None, :, None] + bn.bias[None, :, None])


class ResBlock(nn.Module):
    def __init__(self, cin: int, feats: int, stride: int = 2):
        super().__init__()
        self.conv1 = PlainConv(cin, feats, 3, stride=stride, padding=1)
        self.bn1 = nn.BatchNorm1d(feats, eps=1e-5, momentum=0.1)
        self.conv2 = PlainConv(feats, feats, 3, padding=1)
        self.bn2 = nn.BatchNorm1d(feats, eps=1e-5, momentum=0.1)
        self.residual_path = PlainConv(cin, feats, 1, stride=stride)
        self.res_norm = nn.BatchNorm1d(feats, eps=1e-5, momentum=0.1)

    def forward(self, x, p: Precision, train: bool):
        h = F.relu(batch_norm(self.conv1(x, p), self.bn1, train)).to(p.dtype)
        h = batch_norm(self.conv2(h, p), self.bn2, train)
        res = batch_norm(self.residual_path(x, p), self.res_norm, train)
        return F.relu(h + res).to(p.dtype)


def linear(x, layer: nn.Linear, p: Precision):
    pm = p.mm()
    return (torch.matmul(pm.operand(x), pm.operand(layer.weight).T)
            + layer.bias.to(pm.dtype))


class RelPos(nn.Module):
    """Learned relative-position logits ``[B, H, L, L]`` by the pad-and-
    reshape skew; offsets of ``max_distance`` frames or more get -1e8."""

    def __init__(self, heads: int, head_dim: int, max_distance: int = 100):
        super().__init__()
        self.max_distance = max_distance
        self.embeddings = nn.Parameter(
            torch.empty(heads, 2 * max_distance - 1, head_dim, 1))

    def forward(self, q, p: Precision):
        length = q.shape[2]
        emb = self.embeddings[..., 0]
        if length >= self.max_distance:
            pad = length - self.max_distance
            table = F.pad(emb, (0, 0, pad, pad))
        else:
            start = self.max_distance - length
            table = emb[:, start:start + 2 * length - 1]
        pm = p.mm()
        logits = torch.einsum("bhld,hmd->bhlm", pm.operand(q),
                              pm.operand(table))
        b, h = logits.shape[:2]
        x = F.pad(logits, (0, 1)).reshape(b, h, length * 2 * length)
        x = F.pad(x, (0, length - 1)).reshape(b, h, length + 1,
                                              2 * length - 1)
        out = x[:, :, :length, length - 1:]
        if length > self.max_distance:
            pos = torch.arange(length, device=q.device)
            far = (pos[None, :] - pos[:, None]).abs() >= self.max_distance
            out = out + torch.where(far, -1e8, 0.0).to(out.dtype)
        return out


class Attention(nn.Module):
    def __init__(self, d_model: int, heads: int):
        super().__init__()
        dh = d_model // heads
        self.d_qkv = dh
        self.w_q = nn.Parameter(torch.empty(heads, d_model, dh))
        self.w_k = nn.Parameter(torch.empty(heads, d_model, dh))
        self.w_v = nn.Parameter(torch.empty(heads, d_model, dh))
        self.w_o = nn.Parameter(torch.empty(heads, dh, d_model))
        self.relative_positional = RelPos(heads, dh)

    def forward(self, x, p: Precision, drop):
        pm = p.mm()
        xc = pm.operand(x)

        def project(w):
            return torch.einsum("btf,hfa->bhta", xc, pm.operand(w))

        q, k, v = project(self.w_q), project(self.w_k), project(self.w_v)
        logits = (torch.einsum("bhqa,bhka->bhqk", pm.operand(q),
                               pm.operand(k)).float()
                  / math.sqrt(self.d_qkv))
        logits = logits + self.relative_positional(q, p).float()
        probs = drop(torch.softmax(logits, dim=-1).to(p.dtype))
        o = torch.einsum("bhqk,bhka->bhqa", pm.operand(probs), pm.operand(v))
        return torch.einsum("bhta,haf->btf", pm.operand(o),
                            pm.operand(self.w_o))


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = Attention(d_model, heads)
        self.linear1 = nn.Linear(d_model, ffn)
        self.linear2 = nn.Linear(ffn, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, p: Precision, drop):
        x = self.norm1((x + drop(self.self_attn(x, p, drop))).float()
                       ).to(p.dtype)
        h = drop(F.relu(linear(x, self.linear1, p)))
        h = drop(linear(h, self.linear2, p))
        return self.norm2((x + h).float()).to(p.dtype)


class Encoder(nn.Module):
    """EMG ``[B, T, 8]`` -> (units ``[B, T/16, 256]``, phoneme logits
    ``[B, T/16, 48]``), both f32."""

    def __init__(self, num_ins: int = 8, num_outs: int = UNIT_DIM,
                 num_aux: int = PHONEMES, model_size: int = 768,
                 extra_blocks: int = 3, layers: int = 6, heads: int = 8,
                 ffn: int = 3072):
        super().__init__()
        blocks, cin = [], num_ins
        for _ in range(1 + extra_blocks):
            blocks.append(ResBlock(cin, model_size))
            cin = model_size
        self.conv_blocks = nn.ModuleList(blocks)
        self.w_raw_in = nn.Linear(model_size, model_size)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            [TransformerLayer(model_size, heads, ffn) for _ in range(layers)])
        self.w_out = nn.Linear(model_size, num_outs)
        self.w_aux = nn.Linear(model_size, num_aux)

    def forward(self, emg, p: Precision = F32, train: bool = False,
                shift: int = 0, drop=None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        drop = drop or _identity
        x = emg.to(p.dtype)
        if train and shift:
            x = F.pad(x[:, shift:], (0, 0, 0, shift))
        x = x.transpose(1, 2)
        for block in self.conv_blocks:
            x = block(x, p, train)
        x = linear(x.transpose(1, 2), self.w_raw_in, p)
        for layer in self.transformer.layers:
            x = layer(x, p, drop)
        return (linear(x, self.w_out, p).float(),
                linear(x, self.w_aux, p).float())
