"""K1 bf16's packing for the bf16 tensor cores on the CPU: the packed image
read back as the m16n8k16 B operand, the fragment arithmetic of
csrc/encoder_pool_bf16.cu emulated from the packed bytes (within 2e-2 of
the plain version, layer 0 bit for bit), padding that changes nothing,
the memo that packs once per engine, and the width rules that pick each
instance of K1 bf16 and of K6 (and the wide K6 image read back)."""

import numpy as np
import pytest
import torch

from gan_rl_3d_tpu_torch.ops import encoder_kernel as ek
from gan_rl_3d_tpu_torch.ops.quantize import quantize_encoder

FLAGSHIP = (3, 64, 128, 128, 256, 128)
RAGGED = (3, 24, 40, 72, 200, 8)
WIDTHS = [FLAGSHIP, RAGGED, (3, 20, 36, 100, 8), (3, 100)]
TOL_BF16 = 2e-2  # chip_smoke.TOL_BF16: relative to the largest |ref|


def _layers(dims, seed, dtype=torch.bfloat16):
    """(w, b) layers in ``dtype``: bf16 as a bf16 engine holds them, f32 as
    fused_encoder_pool also takes them with compute_dtype=bfloat16."""
    g = torch.Generator().manual_seed(seed)
    return [(((torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5).to(dtype),
             ((torch.rand(c, generator=g) * 2 - 1) * 0.1).to(dtype))
            for k, c in zip(dims[:-1], dims[1:])]


def _clouds(seed, bsz=3, n=100):
    """Clouds of N = 100 points (the last 16-point slab ragged) and a mask
    that keeps all of cloud 0, part of cloud 1 and none of cloud 2."""
    g = torch.Generator().manual_seed(seed)
    pc = torch.rand(bsz, n, 3, generator=g) * 2 - 1
    keep = torch.tensor([[n], [n // 2 + 3], [0]])[:bsz]
    return pc, (torch.arange(n)[None, :] < keep).float()


def _bf16(x):
    """x rounded to bf16 (nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


def _parts(packed):
    """(w0, b0) and per layer (b, fragments (C/8, K/16, 32, 4) as f32) from
    the packed bytes, in the kernel's layout."""
    data = packed.data.numpy()
    c0 = packed.dims[0]
    w0 = data[:12 * c0].view(np.float32).reshape(3, c0)
    b0 = data[12 * c0:16 * c0].view(np.float32)
    at, parts = 16 * c0, []
    for k, c in zip(packed.dims[:-1], packed.dims[1:]):
        b = data[at:at + 4 * c].view(np.float32)
        at += 4 * c
        words = data[at:at + 2 * k * c].view(np.uint16).astype(np.uint32)
        frag = (words << 16).view(np.float32).reshape(c // 8, k // 16, 32, 4)
        at += 2 * k * c
        parts.append((b, frag))
    assert at == data.size
    return (w0, b0), parts


def _b_operand(frag):
    """(K, C) weights from the fragments, by the PTX ISA's m16n8k16 B
    fragment: lane 4g + t holds rows 2t, 2t + 1 (b0, b1) and 2t + 8,
    2t + 9 (b2, b3) of column g; slot 2h + e is row 16kc + 8h + 2t + e of
    column 8j + g."""
    nt, nkc = frag.shape[:2]
    w = np.zeros((16 * nkc, 8 * nt), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for slot in range(4):
            rows = 16 * np.arange(nkc) + 8 * (slot >> 1) + 2 * t + (slot & 1)
            w[np.ix_(rows, 8 * np.arange(nt) + g)] = frag[:, :, lane, slot].T
    return w


def _a_registers(y):
    """The kernel's A registers from a stack of slabs' layer outputs y
    (S, 16, K), as encoder_pool_bf16.cu packs them: for K chunk kc, thread
    (g, t) packs its accumulators of output tiles 2kc (registers 0, 1) and
    2kc + 1 (registers 2, 3), rows g (0, 2) and g + 8 (1, 3), columns
    2t, 2t + 1 of the tile (the m16n8 accumulator layout). (S, 32 lanes,
    K/16, 4 registers, 2 halves)."""
    s, _, k = y.shape
    regs = np.empty((s, 32, k // 16, 4, 2), y.dtype)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for kc in range(k // 16):
            for r in range(4):
                col = 8 * (2 * kc + (r >> 1)) + 2 * t
                regs[:, lane, kc, r] = y[:, g + 8 * (r & 1), col:col + 2]
    return regs


def _a_operand(regs):
    """The (S, 16, K) A operand that the registers hold, by the PTX ISA's
    m16n8k16 A fragment: a0, a1 at row g, columns 2t, 2t + 1; a2, a3 at
    row g + 8; a4, a5 at row g, columns 2t + 8, 2t + 9; a6, a7 at row
    g + 8."""
    s, _, nkc = regs.shape[:3]
    a = np.full((s, 16, 16 * nkc), np.nan, regs.dtype)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for kc in range(nkc):
            for r in range(4):
                col = 16 * kc + 8 * (r >> 1) + 2 * t
                a[:, g + 8 * (r & 1), col:col + 2] = regs[:, lane, kc, r]
    return a


def _dot_f64(a, w):
    """a (S, 16, K) @ w (K, C), each product exact in f64 and summed in
    increasing k, so zero terms change no bit."""
    acc = np.zeros(a.shape[:2] + (w.shape[1],), np.float64)
    for k in range(w.shape[0]):
        acc += a[:, :, k:k + 1].astype(np.float64) * w[k].astype(np.float64)
    return acc


def _layer0(x, w0, b0):
    """((x0 w0 + x1 w1) + x2 w2) + b, then ReLU, in f32 step by step."""
    y = ((x[..., 0:1] * w0[0] + x[..., 1:2] * w0[1]) + x[..., 2:3] * w0[2]
         + b0)
    return np.maximum(y, np.float32(0))


def _pool(y, pc, mask, c_last):
    """bf16-rounded outputs of the slabs (S, 16, C) -> (B, c_last) maxima
    over the valid points."""
    bsz, n, _ = pc.shape
    y = _bf16(y).reshape(bsz, -1, y.shape[-1])[:, :n, :c_last]
    if mask is not None:
        y = np.where(mask.numpy()[..., None] > 0, y, -np.inf)
    return y.max(axis=1)


def _slabs(pc):
    """The cloud rounded to bf16 in 16-point slabs (S, 16, 3), rows past N
    zero, as each warp reads it."""
    bsz, n, _ = pc.shape
    x = np.zeros((bsz, -(-n // 16) * 16, 3), np.float32)
    x[:, :n] = pc.to(torch.bfloat16).float().numpy()
    return x.reshape(-1, 16, 3)


def _emulate(packed, pc, mask):
    """K1 bf16's tensor-core instance on the CPU from its packed image:
    layer 0 on the CUDA cores, then per layer the A registers packed from
    the accumulators (rounded to bf16 as cvt.rn.bf16x2.f32), the B
    fragments from the image, the products summed in f64 (the tensor cores
    sum in their own order), + bias, ReLU; the bf16-rounded last layer
    max-pooled over the valid points."""
    (w0, b0), parts = _parts(packed)
    y = _layer0(_slabs(pc), w0, b0)
    for b, frag in parts:
        a = _a_operand(_a_registers(_bf16(y)))
        y = np.maximum(_dot_f64(a, _b_operand(frag)).astype(np.float32) + b,
                       np.float32(0))
    return _pool(y, pc, mask, packed.c_last)


def _chain_f64(pc, layers, mask):
    """The same arithmetic on the unpadded layers, with no fragments."""
    w0, b0 = (x.float().numpy() for x in layers[0])
    y = _layer0(_slabs(pc), w0, b0)
    for w, b in layers[1:]:
        y = np.maximum(_dot_f64(_bf16(y), w.float().numpy())
                       .astype(np.float32) + b.float().numpy(), np.float32(0))
    return _pool(y, pc, mask, layers[-1][0].shape[1])


@pytest.mark.parametrize("dims", WIDTHS)
def test_bf16_packer_reads_back_as_the_mma_b_operand(dims):
    """Read back as the B operand ([K_pad][C_pad], the fragment order
    undone), every layer equals the bf16 weights with zeros in the
    padding and its bias with zeros past C; w0 holds the bf16 values of
    layer 0's weights as f32, zero-padded, and b0 its bias."""
    layers = _layers(dims, 1)
    packed = ek.pack_bf16_encoder(layers)
    assert packed.dims == tuple(-(-c // 16) * 16 for c in dims[1:])
    assert packed.c_last == dims[-1] and packed.instance == "mma"
    assert packed.data.numel() == ek.bf16_image_bytes(packed.dims)
    (w0, b0), parts = _parts(packed)
    c0 = dims[1]
    np.testing.assert_array_equal(w0[:, :c0], layers[0][0].float().numpy())
    np.testing.assert_array_equal(b0[:c0], layers[0][1].float().numpy())
    assert not w0[:, c0:].any() and not b0[c0:].any()
    for (w, b), (pb, frag), k, c in zip(layers[1:], parts, dims[1:-1],
                                        dims[2:]):
        wb = _b_operand(frag)
        assert wb.shape == (-(-k // 16) * 16, -(-c // 16) * 16)
        np.testing.assert_array_equal(wb[:k, :c], w.float().numpy())
        assert not wb[k:].any() and not wb[:, c:].any()
        np.testing.assert_array_equal(pb[:c], b.float().numpy())
        assert not pb[c:].any()


@pytest.mark.parametrize("k", [16, 64, 256])
def test_accumulators_are_the_next_layers_a_operand(k):
    """The registers that the epilogue packs from the accumulator layout
    hold, by the PTX ISA's A fragment table, exactly the slab's outputs:
    no permutation and no shuffle between layers."""
    y = np.random.RandomState(k).randn(5, 16, k).astype(np.float32)
    np.testing.assert_array_equal(_a_operand(_a_registers(y)), y)


@pytest.mark.parametrize("dims", WIDTHS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fragment_arithmetic_stays_within_2e2_of_plain(dims, masked, dtype):
    """The emulation from the packed bytes against fused_encoder_pool_plain
    at N = 100 (a ragged last slab), for bf16 layers and for f32 layers
    (rounded to bf16 by the packer as by the plain version): the same -inf
    (the fully masked cloud), within 2e-2 of the largest |ref|; layer 0
    alone bit for bit."""
    layers = _layers(dims, 3, dtype)
    pc, mask = _clouds(4)
    m = mask if masked else None
    out = _emulate(ek.pack_bf16_encoder(layers), pc, m)
    ref = ek.fused_encoder_pool_plain(pc, layers, m,
                                      compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.any() and (not masked or np.isneginf(out[2]).all())
    err = np.abs(out[fin] - ref[fin]).max() / np.abs(ref[fin]).max()
    assert err <= TOL_BF16, err
    out0 = _emulate(ek.pack_bf16_encoder(layers[:1]), pc, m)
    ref0 = ek.fused_encoder_pool_plain(pc, layers[:1], m,
                                       compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(out0, ref0)


@pytest.mark.parametrize("dims", WIDTHS)
@pytest.mark.parametrize("masked", [False, True])
def test_padding_changes_nothing(dims, masked):
    """The emulation on the padded image equals, bit for bit, the same
    arithmetic on the unpadded layers: a padded channel is ReLU(0) = 0 and
    its products add exact zeros."""
    layers = _layers(dims, 5)
    pc, mask = _clouds(6)
    m = mask if masked else None
    np.testing.assert_array_equal(
        _emulate(ek.pack_bf16_encoder(layers), pc, m),
        _chain_f64(pc, layers, m))


def test_bf16_pack_memo_packs_once_per_engine_and_again_after_an_edit():
    """Repeated lookups of one engine's layers pack once; an in-place edit
    of a weight bumps its version and repacks, with the edit in the new
    image; other layers pack on their own."""
    memo = ek.Bf16PackMemo()
    layers = _layers(FLAGSHIP, 7)
    first = memo(layers)
    for _ in range(3):
        assert memo(layers) is first
    assert memo.packs == 1
    before = first.data.clone()
    w = layers[2][0]
    w[0, 0] = -w[0, 0] if w[0, 0] != 0 else 1
    again = memo(layers)
    assert memo.packs == 2 and again is not first
    assert not torch.equal(again.data, before)
    assert memo(layers) is again and memo.packs == 2
    memo(_layers(FLAGSHIP, 8))
    assert memo.packs == 3


@pytest.mark.parametrize("dims,bf16,int8", [
    (FLAGSHIP, "mma", "mma"),
    (RAGGED, "mma", "mma"),
    ((3, 100), "mma", "mma"),
    ((3, 16, 256), "mma", "mma"),
    ((3, 16, 257), "wide", "wide"),                  # past 256 after padding
    ((3, 64, 512, 128), "wide", "wide"),
    ((3, 512, 512, 96), "wide", "wide"),
    ((3, 907, 907, 8), "wide", "wide"),
    ((3, 256, 256, 256, 256, 256), "wide", "wide"),  # images past 227 KB
])
def test_width_rules_pick_each_instance(dims, bf16, int8):
    assert ek.bf16_instance(dims) == bf16
    assert ek.int8_instance(dims) == int8


@pytest.mark.parametrize("dims", [(3, 908, 908, 8), (3, 1024, 1024, 128)])
def test_bf16_width_rule_refuses_what_no_instance_takes(dims):
    with pytest.raises(ValueError, match="exceed K1's shared memory"):
        ek.bf16_instance(dims)
    with pytest.raises(ValueError, match="exceed K1's shared memory"):
        ek.pack_bf16_encoder(_layers(dims, 9))


@pytest.mark.parametrize("dims", [(3, 16, 1800), (3, 1472, 1472, 8)])
def test_int8_width_rule_refuses_what_no_instance_takes(dims):
    with pytest.raises(ValueError, match="exceed K6's shared memory"):
        ek.int8_instance(dims)


def test_bf16_packer_refuses_what_the_mma_instance_cannot_take():
    with pytest.raises(ValueError, match="tensor-core instance"):
        ek.pack_bf16_encoder(_layers((3, 64, 512, 128), 10))


def _qenc(dims, seed):
    g = torch.Generator().manual_seed(seed)
    return quantize_encoder([((torch.rand(k, c, generator=g) * 2 - 1)
                              / k ** 0.5,
                              (torch.rand(c, generator=g) * 2 - 1) * 0.1)
                             for k, c in zip(dims[:-1], dims[1:])])


@pytest.mark.parametrize("dims,force", [((3, 64, 512, 128), None),
                                        ((3, 907, 907, 8), None),
                                        (FLAGSHIP, "wide"),
                                        ((3, 100), None)])
def test_int8_wide_image_reads_back_as_the_dp4a_words(dims, force):
    """K6's wide image: w0 and b0, then per layer s_w, b and the int8
    weights as int32 words of four along K (byte i of word [k4, c] is row
    4 k4 + i), equal to the padded bundle; (3, 100) has no quantized
    layer and takes the mma.sync instance."""
    qenc = _qenc(dims, 11)
    packed = ek.pack_int8_encoder(qenc, force)
    assert packed.instance == ("mma" if dims == (3, 100) else "wide")
    assert packed.c_last == dims[-1]
    padded = ek.pad_int8_encoder(qenc)
    data = packed.data.numpy()
    c0 = packed.dims[0]
    np.testing.assert_array_equal(data[:12 * c0].view(np.float32),
                                  padded["layer0"][0].numpy().reshape(-1))
    at = 16 * c0
    for wq, s_w, b in padded["layers_q"]:
        k, c = wq.shape
        np.testing.assert_array_equal(data[at:at + 4 * c].view(np.float32),
                                      s_w.numpy()[0])
        np.testing.assert_array_equal(
            data[at + 4 * c:at + 8 * c].view(np.float32), b.numpy()[0])
        at += 8 * c
        words = data[at:at + k * c].view(np.int8).reshape(k // 4, c, 4)
        np.testing.assert_array_equal(
            words.transpose(0, 2, 1).reshape(k, c), wq.numpy())
        at += k * c
    assert at == data.size
    assert packed.data.numel() == ek.int8_image_bytes(packed.dims)
