"""K6's packing for the int8 tensor cores on the CPU: the packed bundle read
back as the m16n8k32 B operand, the fragment arithmetic of
csrc/encoder_pool_int8.cu emulated from the packed bytes, padding that
moves no bit of the plain version, the memo that packs once per bundle,
and the widths the packer refuses."""

import numpy as np
import pytest
import torch

from gan_rl_3d_tpu_torch.ops import encoder_kernel as ek
from gan_rl_3d_tpu_torch.ops.quantize import int8_matmul, quantize_encoder

FLAGSHIP = (3, 64, 128, 128, 256, 128)
RAGGED = (3, 20, 36, 100, 8)
WIDTHS = [FLAGSHIP, (3, 16, 20), RAGGED]


def _qenc(dims, seed):
    g = torch.Generator().manual_seed(seed)
    layers = [((torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5,
               (torch.rand(c, generator=g) * 2 - 1) * 0.1)
              for k, c in zip(dims[:-1], dims[1:])]
    return quantize_encoder(layers)


def _layer_parts(packed):
    """Per layer (s_w, b, fragments (C/8, K/32, 32, 8) int8) from the
    packed bytes, in the kernel's layout; and layer 0's (w0, b0)."""
    data = packed.data.numpy()
    c0 = packed.dims[0]
    w0 = data[:12 * c0].view(np.float32).reshape(3, c0)
    b0 = data[12 * c0:16 * c0].view(np.float32)
    at, parts = 16 * c0, []
    for k, c in zip(packed.dims[:-1], packed.dims[1:]):
        s_w = data[at:at + 4 * c].view(np.float32)
        b = data[at + 4 * c:at + 8 * c].view(np.float32)
        at += 8 * c
        frag = data[at:at + k * c].view(np.int8).reshape(c // 8, k // 32,
                                                         32, 8)
        at += k * c
        parts.append((s_w, b, frag))
    assert at == data.size
    return (w0, b0), parts


def _b_operand(frag):
    """(K_pad, C_pad) weights from the fragments: lane 4g + t holds rows
    16h + 4t + i of column 8j + g in slot (h, i), rows in INT8_K_ORDER."""
    nt, nkc = frag.shape[:2]
    slots = frag.reshape(nt, nkc, 8, 4, 2, 4).transpose(1, 4, 3, 5, 0, 2)
    slots = slots.reshape(nkc, 32, nt * 8)            # (kc, slot, column)
    w = np.empty_like(slots)
    w[:, list(ek.INT8_K_ORDER), :] = slots
    return w.reshape(nkc * 32, nt * 8)


@pytest.mark.parametrize("dims", WIDTHS)
def test_packer_reads_back_as_the_mma_b_operand(dims):
    """Read back as the B operand ([C_pad][K_pad], the K order and the
    fragment order undone), every layer equals wq with zeros in the
    padding, s_w = 1 and b = 0 in the padded channels, and layer 0 is
    padded with zero columns; the integer product of the read-back
    operand is exact (int8_matmul, the plain version's product, agrees)."""
    qenc = _qenc(dims, 1)
    packed = ek.pack_int8_encoder(qenc)
    assert packed.dims == tuple(-(-c // 32) * 32 for c in dims[1:])
    assert packed.c_last == dims[-1]
    (w0, b0), parts = _layer_parts(packed)
    c0 = dims[1]
    np.testing.assert_array_equal(w0[:, :c0], qenc["layer0"][0].numpy())
    np.testing.assert_array_equal(b0[:c0], qenc["layer0"][1].numpy()[0])
    assert not w0[:, c0:].any() and not b0[c0:].any()
    g = torch.Generator().manual_seed(2)
    for (wq, s_w, b), (ps, pb, frag), k, c in zip(
            qenc["layers_q"], parts, dims[1:-1], dims[2:]):
        w = _b_operand(frag)
        assert w.shape == (-(-k // 32) * 32, -(-c // 32) * 32)
        np.testing.assert_array_equal(w[:k, :c], wq.numpy())
        assert not w[k:].any() and not w[:, c:].any()
        np.testing.assert_array_equal(ps[:c], s_w.numpy()[0])
        np.testing.assert_array_equal(pb[:c], b.numpy()[0])
        assert (ps[c:] == 1.0).all() and not pb[c:].any()
        xq = torch.randint(-127, 128, (5, k), generator=g).to(torch.int8)
        exact = xq.long() @ wq.long()
        assert torch.equal(int8_matmul(xq, wq).long(), exact)
        xp = torch.zeros(5, w.shape[0], dtype=torch.long)
        xp[:, :k] = xq.long()
        assert torch.equal((xp @ torch.from_numpy(w).long())[:, :c], exact)


@pytest.mark.parametrize("dims", WIDTHS)
def test_fragment_arithmetic_gives_the_int8_product(dims):
    """The kernel's fragment arithmetic, emulated thread by thread from the
    packed bytes: thread (g, t) builds its A registers from the outputs the
    m16n8 accumulator layout left it (rows g, g + 8; columns 8j + 2t + e),
    takes its B registers from the fragments, and the m16n8k32 products
    (PTX ISA fragment tables) sum to the exact int8 product of the slab."""
    qenc = _qenc(dims, 3)
    padded = ek.pad_int8_encoder(qenc)
    _, parts = _layer_parts(ek.pack_int8_encoder(qenc))
    rng = np.random.RandomState(4)
    for (wq, _, _), (_, _, frag) in zip(padded["layers_q"], parts):
        k, c = wq.shape
        x = rng.randint(-127, 128, (16, k))  # the slab's quantized inputs
        a_mat = np.zeros((16, k), np.int64)  # A as the fragments hold it
        b_mat = np.zeros((k, c), np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for kc in range(k // 32):
                for h in range(2):        # registers a0/a1 (h=0), a2/a3
                    for r in range(2):    # rows g, g + 8
                        j = 4 * kc + 2 * h
                        held = [x[g + 8 * r, 8 * jj + 2 * t + e]
                                for jj in (j, j + 1) for e in range(2)]
                        col = 32 * kc + 16 * h + 4 * t
                        a_mat[g + 8 * r, col:col + 4] = held
                for j in range(c // 8):
                    b = frag[j, kc, lane].astype(np.int64)
                    b_mat[32 * kc + 4 * t:32 * kc + 4 * t + 4, 8 * j + g] = b[:4]
                    b_mat[32 * kc + 16 + 4 * t:32 * kc + 20 + 4 * t,
                          8 * j + g] = b[4:]
        np.testing.assert_array_equal(a_mat @ b_mat,
                                      x @ wq.numpy().astype(np.int64))


@pytest.mark.parametrize("masked", [False, True])
def test_padding_changes_no_bit(masked):
    """The plain version on the padded bundle, its outputs cut to C_last,
    equals the plain version on the original bundle bit for bit."""
    qenc = _qenc(RAGGED, 5)
    g = torch.Generator().manual_seed(6)
    pc = torch.rand(3, 300, 3, generator=g) * 2 - 1
    mask = (torch.arange(300)[None, :]
            < torch.tensor([[300], [170], [0]])).float()
    m = mask if masked else None
    ref = ek.fused_encoder_pool_int8_plain(pc, qenc, m)
    out = ek.fused_encoder_pool_int8_plain(pc, ek.pad_int8_encoder(qenc), m)
    assert out.shape == (3, 32) and ref.shape == (3, RAGGED[-1])
    assert torch.equal(out[:, :RAGGED[-1]], ref)


def test_pack_memo_packs_once_and_again_after_an_in_place_edit():
    """Repeated lookups of one bundle pack once; an in-place edit of a wq
    bumps its version and repacks, with the edit in the new image; another
    bundle packs on its own."""
    memo = ek.Int8PackMemo()
    qenc = _qenc(FLAGSHIP, 7)
    first = memo(qenc)
    for _ in range(3):
        assert memo(qenc) is first
    assert memo.packs == 1
    before = first.data.clone()
    wq = qenc["layers_q"][2][0]
    wq[0, 0] = -wq[0, 0] if wq[0, 0] != 0 else 1
    again = memo(qenc)
    assert memo.packs == 2 and again is not first
    assert not torch.equal(again.data, before)
    assert memo(qenc) is again and memo.packs == 2
    memo(_qenc(FLAGSHIP, 8))
    assert memo.packs == 3


def test_packer_refuses_what_the_kernel_cannot_take():
    """Widths the mma.sync instance cannot take (past 256 after padding, or
    a bundle past shared memory) select the wide instance; the packer
    refuses what no instance takes, and the mma.sync layout for widths
    that only the wide instance takes."""
    assert ek.pack_int8_encoder(_qenc((3, 16, 257), 9)).instance == "wide"
    assert ek.pack_int8_encoder(
        _qenc((3, 256, 256, 256, 256, 256, 8), 10)).instance == "wide"
    with pytest.raises(ValueError, match="exceed K6's shared memory"):
        ek.pack_int8_encoder(_qenc((3, 16, 1800), 9))
    with pytest.raises(ValueError, match="does not take"):
        ek.pack_int8_encoder(_qenc((3, 16, 257), 9), "mma")
    qenc = _qenc(RAGGED, 11)
    wq, s_w, b = qenc["layers_q"][0]
    with pytest.raises(ValueError, match="int8"):
        ek.pack_int8_encoder({**qenc, "layers_q": [(wq.float(), s_w, b)]
                              + qenc["layers_q"][1:]})
