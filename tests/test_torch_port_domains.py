"""The port's kernel domains and the dispatch around them, on the CPU (no card, no nvcc).

Each kernel states its domain as a pure check made before any launch:
``flash_attention._k1_domain`` (K1: head dim 32 or 64, a batch within the grid's z extent),
``_k2_domain`` (K2: K1's at head dim 32 only), ``_k7_domain`` (K7: head dim 32 or 64, query
tiles within the grid's y extent), ``ln_dense._in_domain`` (K3: 0 < C <= 1024, C % 32 == 0,
fewer than 2^31 rows, 1 to 3 outputs with F % 64 == 0), ``ln_dense._bwd_in_domain`` (K4: K3's
at C <= 256) and ``ln_mlp._in_domain`` (K5: K3's at C <= 256 and 0 < O <= 256, O % 32 == 0, or the wide rows
256 < C = O <= 512, C % 128 == 0, F = 4C, and past them in bf16 only up to C = O = 1024,
base300M's MLP):
the forward kernels were widened for the Point-E path, the backward ones were not, so no
backward is handed a shape it was not built for. A CUDA
tensor inside the domain launches the kernel; outside it takes the plain version, as the
JAX package sends such shapes to XLA. Here the card is stood in for by patching the device
gate (``_on_card``) and each ``_launch`` by a spy, so
the tests see which path a shape takes; ``_launch``'s own checks still refuse a shape
outside the domain. Also: the wrapper's bf16 copy of W (cast once per parameter version,
taken again until an in-place update, held only while the weight lives), which K5's bf16
launch takes too, and the column groups of K3's grid.
"""

import contextlib
import gc

import pytest
import torch

from pcdiff_torch.ops import flash_attention as fa
from pcdiff_torch.ops import ln_dense as ld
from pcdiff_torch.ops import ln_mlp as lm
from pcdiff_torch.train import create_train_state

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores


class _Spy:
    """Stands in for a kernel's ``_launch``: records the call, returns the plain result."""

    def __init__(self, plain):
        self.calls, self.plain = 0, plain

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.plain(*args, **kwargs)


@pytest.fixture
def card(monkeypatch):
    """CPU tensors take the kernels' branch of every dispatch; each ``_launch`` is a spy."""
    monkeypatch.setattr(fa, "_on_card", lambda q: True)
    monkeypatch.setattr(ld, "_on_card", lambda x: True)
    spies = {
        "k1": _Spy(lambda q, k, v, h: fa._torch_attention_mh(q, k, v, h, q.dtype)),
        "k2": _Spy(lambda q, k, v, g, h: fa._torch_attention_mh_bwd(q, k, v, g, h, q.dtype)),
        "k7": _Spy(fa._torch_attention),
        "k3": _Spy(lambda *a, **kw: ld._torch_ln_denses(*a)),
        "k4": _Spy(ld._torch_ln_denses_bwd),
        "k5": _Spy(lm._torch_ln_mlp),
    }
    for mod, name, key in ((fa, "_launch", "k1"), (fa, "_launch_bwd", "k2"),
                           (fa, "_launch_split", "k7"), (ld, "_launch", "k3"),
                           (ld, "_launch_bwd", "k4"), (lm, "_launch", "k5")):
        monkeypatch.setattr(mod, name, spies[key])
    return spies


# (H * D, heads, dtype, in K1's domain, in K2's domain)
MH_CASES = [
    (256, 8, torch.float32, True, True),       # the flagship: 8 heads of 32
    (128, 4, torch.bfloat16, True, True),
    (128, 8, torch.float32, False, False),     # synthetic_quality.yaml: head dim 16
    (32, 4, torch.float32, False, False),      # smoke.yaml: head dim 8
    (256, 4, torch.float32, True, False),      # head dim 64: the SDF model's 4 heads
    (512, 8, torch.bfloat16, True, False),     # base40M and the upsampler
    (1024, 16, torch.float32, True, False),    # the ViT-L/14 tower
    (768, 12, torch.bfloat16, True, False),    # the CLIP text tower's width
    (1024, 8, torch.float32, False, False),    # head dim 128: just outside
    (96, 5, torch.float32, False, False),      # heads do not divide the width
    (256, 8, torch.float64, False, False),     # gradcheck's dtype
]


@pytest.mark.parametrize("hd,heads,dtype,k1,k2", MH_CASES)
def test_k1_domain(hd, heads, dtype, k1, k2):
    assert fa._k1_domain(torch.zeros(2, 5, hd, dtype=dtype), heads) is k1


@pytest.mark.parametrize("hd,heads,dtype,k1,k2", MH_CASES)
def test_k2_domain(hd, heads, dtype, k1, k2):
    assert fa._k2_domain(torch.zeros(2, 5, hd, dtype=dtype), heads) is k2


@pytest.mark.parametrize("batch,want", [(65535, True), (65536, False)])
def test_k1_domain_at_the_grid_edge(batch, want):
    """K1 and K2 put the batch on the grid's z extent (65535 at most)."""
    q = torch.zeros(1, 3, 256).expand(batch, 3, 256)  # no memory behind the batch
    assert fa._k1_domain(q, 8) is want and fa._k2_domain(q, 8) is want
    assert fa._k1_domain(q, 4) is want and not fa._k2_domain(q, 4)  # head dim 64


@pytest.mark.parametrize("nq,want", [(64 * 65535, True), (64 * 65535 + 1, False)])
def test_k7_domain_at_the_grid_edge(nq, want):
    """K7 puts its 64-query tiles on the grid's y extent (65535 at most)."""
    q = torch.zeros(1, 2, 1, 32).expand(1, 2, nq, 32)
    assert fa._k7_domain(q) is want


@pytest.mark.parametrize("rows,want", [(2**31 - 1, True), (2**31, False)])
def test_ln_dense_domain_at_the_row_limit(rows, want):
    """K3's grid is one-dimensional, so only the C interface's int rows bound it."""
    x = torch.zeros(1, 1, 32).expand(rows, 1, 32)
    assert ld._in_domain(x, [torch.zeros(64, 32)], torch.float32) is want


@pytest.mark.parametrize("d,transposed,want", [
    (32, True, True), (64, False, True), (16, True, False), (128, False, False),
])
def test_k7_domain(d, transposed, want):
    q = torch.zeros(2, 7, 3, d)
    q = q.transpose(1, 2) if transposed else q.permute(0, 2, 1, 3).contiguous()
    assert fa._k7_domain(q) is want
    # a row whose D elements are not contiguous is outside K7's domain too
    assert not fa._k7_domain(torch.zeros(2, 3, d, 7).transpose(-1, -2))


# (C, F_i, x dtype, output dtype, in K3's domain, in K4's domain)
LN_CASES = [
    (256, (256, 256, 256), torch.bfloat16, torch.bfloat16, True, True),  # the flagship's qkv
    (256, (1024,), torch.float32, torch.float32, True, True),
    (128, (384, 512), torch.bfloat16, torch.bfloat16, True, True),       # synthetic_quality
    (32, (128,), torch.float32, torch.float32, True, True),              # smoke.yaml
    (320, (256,), torch.float32, torch.float32, True, False),            # C > 256: K3 wide
    (512, (512, 512, 512), torch.bfloat16, torch.bfloat16, True, False),  # Point-E qkv
    (512, (2048,), torch.float32, torch.float32, True, False),           # Point-E fc1
    (768, (3072,), torch.float32, torch.bfloat16, True, False),          # CLIP text fc1
    (1024, (1024,) * 3, torch.float32, torch.float32, True, False),      # ViT-L/14 qkv
    (1056, (256,), torch.float32, torch.float32, False, False),          # C > 1024
    (112, (256,), torch.float32, torch.float32, False, False),           # C % 32
    (256, (256, 96), torch.float32, torch.float32, False, False),        # F % 64
    (256, (64,) * 4, torch.float32, torch.float32, False, False),        # four outputs
    (256, (256,), torch.float64, torch.float64, False, False),           # gradcheck's dtype
    (256, (256,), torch.float32, torch.float16, False, False),
]


@pytest.mark.parametrize("c,fs,dtype,out,k3,k4", LN_CASES)
def test_ln_dense_domain(c, fs, dtype, out, k3, k4):
    x = torch.zeros(2, 3, c, dtype=dtype)
    assert ld._in_domain(x, [torch.zeros(f, c) for f in fs], out) is k3


@pytest.mark.parametrize("c,fs,dtype,out,k3,k4", LN_CASES)
def test_ln_dense_bwd_domain(c, fs, dtype, out, k3, k4):
    x = torch.zeros(2, 3, c, dtype=dtype)
    assert ld._bwd_in_domain(x, [torch.zeros(f, c) for f in fs], out) is k4


@pytest.mark.parametrize("c,f,o,want", [
    (256, 1024, 256, True), (128, 512, 128, True), (256, 1024, 512, False),
    (256, 1024, 48, False), (320, 1024, 256, False), (256, 1000, 256, False),
    (512, 2048, 512, True),  # Point-E's MLP: the wide rows, C = O, F = 4C
    (640, 2560, 640, False),  # the first such shape past the wide rows' C <= 512
])
def test_ln_mlp_domain(c, f, o, want):
    x = torch.zeros(2, 3, c)
    assert lm._in_domain(x, torch.zeros(f, c), torch.zeros(o, f), torch.float32) is want


@pytest.mark.parametrize("c,f,o,out,want", [
    (1024, 4096, 1024, torch.bfloat16, True),   # base300M's MLP
    (768, 3072, 768, torch.bfloat16, True),     # between the wide rows and 1024, C % 128 == 0
    (1024, 4096, 1024, torch.float32, False),   # fp32 there: the plain version, as XLA's
    (1152, 4608, 1152, torch.bfloat16, False),  # past 1024
    (1024, 2048, 1024, torch.bfloat16, False),  # F != 4C
    (1024, 4096, 512, torch.bfloat16, False),   # O != C
    (960, 3840, 960, torch.bfloat16, False),    # C % 128 != 0
])
def test_ln_mlp_domain_past_the_wide_rows(c, f, o, out, want):
    """K5 past C = 512 takes bf16 outputs only, from x in either dtype."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, 3, c, dtype=dtype)
        assert lm._in_domain(x, torch.zeros(f, c), torch.zeros(o, f), out) is want


def _mlp300_args(out, seed=4):
    """base300M's MLP (C = O = 1024, F = 4096) on a few rows of bf16 x."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 5, 1024, generator=g).bfloat16()
    return (x, torch.ones(1024), torch.zeros(1024), torch.randn(4096, 1024, generator=g) / 32,
            torch.zeros(4096), torch.randn(1024, 4096, generator=g) / 64, torch.zeros(1024),
            1e-5, out, "gelu")


@pytest.mark.parametrize("out,kernel", [(torch.bfloat16, True), (torch.float32, False)])
def test_ln_mlp_dispatch_past_the_wide_rows(card, out, kernel):
    """base300M's MLP on the card: bf16 outputs launch K5, fp32 ones take the plain version."""
    args = _mlp300_args(out)
    torch.testing.assert_close(lm.fused_ln_mlp(*args), lm._torch_ln_mlp(*args))
    assert card["k5"].calls == int(kernel)


def test_ln_mlp_past_the_wide_rows_on_the_cpu_is_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version at base300M's widths: no launch."""
    def no_kernel():
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(lm, "_kernel_fn", no_kernel)
    monkeypatch.setattr(lm, "launches", 0)
    args = _mlp300_args(torch.bfloat16)
    assert torch.equal(lm.fused_ln_mlp(*args), lm._torch_ln_mlp(*args))
    assert lm.launches == 0


def test_ln_mlp_launch_past_the_wide_rows_counts_by_width(monkeypatch):
    """A bf16 launch at C = 1024 hands the kernel the weights' bf16 copies and counts once in
    ``launches`` and once under C in ``width_launches``; an fp32 one raises before it builds."""
    seen = []

    def kernel(*args):
        seen.append((args[3], args[5], args[9:12]))  # w1, w2, (C, F, O)
        return 0

    monkeypatch.setattr(lm, "_kernel_fn", lambda: kernel)
    monkeypatch.setattr(lm._native, "stream", lambda device: 0)
    monkeypatch.setattr(lm.torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(lm, "launches", 0)
    monkeypatch.setattr(lm, "width_launches", {})
    args = _mlp300_args(torch.bfloat16)
    lm._launch(*args)
    w1, w2 = ld._W_BF16[args[3]][1], ld._W_BF16[args[5]][1]
    assert seen == [(w1.data_ptr(), w2.data_ptr(), (1024, 4096, 1024))]
    assert lm.launches == 1 and lm.width_launches == {1024: 1}
    with pytest.raises(ValueError, match="bf16 outputs"):
        lm._launch(*_mlp300_args(torch.float32))
    assert lm.launches == 1 and len(seen) == 1


def _attn(b, n, hd, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, hd, generator=g, dtype=dtype).requires_grad_() for _ in range(3)]


@pytest.mark.parametrize("hd,heads,calls", [(256, 8, (1, 1)), (128, 8, (0, 0)), (32, 4, (0, 0)),
                                            (256, 4, (1, 0)), (1024, 16, (1, 0))])
def test_attention_dispatch_follows_the_domain(card, hd, heads, calls):
    """(K1, K2) launches of a forward and backward: at head dim 64 the forward launches K1
    and the backward takes the plain version."""
    q, k, v = _attn(2, 9, hd)
    out = fa.fused_attention_mh(q, k, v, heads)
    out.sum().backward()
    assert (card["k1"].calls, card["k2"].calls) == calls
    # the plain version off the domain computes the same function
    torch.testing.assert_close(out, fa._torch_attention_mh(q, k, v, heads, q.dtype),
                               rtol=0, atol=0)


@pytest.mark.parametrize("d,kernel", [(32, True), (16, False)])
def test_head_split_dispatch_follows_the_domain(card, d, kernel):
    q, k, v = (t.view(2, 9, 4, d).transpose(1, 2) for t in _attn(2, 9, 4 * d))
    fa.fused_attention(q, k, v)
    assert card["k7"].calls == int(kernel)


@pytest.mark.parametrize("c,fs,calls", [(256, (256, 256), (1, 1)), (128, (512,), (1, 1)),
                                        (320, (256,), (1, 0)), (512, (1536,), (1, 0)),
                                        (1056, (256,), (0, 0)), (256, (96,), (0, 0))])
def test_ln_dense_dispatch_follows_the_domain(card, c, fs, calls):
    """(K3, K4) calls of a forward and backward: past C = 256 the forward launches K3 and
    the backward takes the plain version."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, c, generator=g, requires_grad=True)
    ws = [torch.randn(f, c, generator=g, requires_grad=True) for f in fs]
    bs = [torch.randn(f, generator=g) for f in fs]
    outs = ld.fused_ln_denses(x, torch.ones(c), torch.zeros(c), ws, bs, 1e-5, torch.float32,
                              ["gelu"] * len(fs))
    sum(o.sum() for o in outs).backward()
    assert (card["k3"].calls, card["k4"].calls) == calls


@pytest.mark.parametrize("o,kernel", [(256, True), (512, False)])
def test_ln_mlp_dispatch_follows_the_domain(card, o, kernel):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, 256, generator=g)
    args = (x, torch.ones(256), torch.zeros(256), torch.randn(1024, 256, generator=g) / 16,
            torch.zeros(1024), torch.randn(o, 1024, generator=g) / 32, torch.zeros(o), 1e-5,
            torch.float32, "gelu")
    torch.testing.assert_close(lm.fused_ln_mlp(*args), lm._torch_ln_mlp(*args))
    assert card["k5"].calls == int(kernel)


def test_softmax_switch_off_the_domain_takes_the_xla_twin(card):
    """Under the bf16 exp switch a shape outside K1's domain computes the JAX XLA twin's
    function (weights normalised before PV), one inside it K1's plain version."""
    q, k, v = (t.detach() for t in _attn(2, 9, 128))
    fa.set_attention_softmax_dtype("bfloat16")
    try:
        assert fa.attention_softmax_dtype() == "bfloat16"
        off = fa.fused_attention_mh(q, k, v, 8)  # head dim 16
        inside = fa.fused_attention_mh(q, k, v, 4)  # head dim 32: the spy, K1's plain version
    finally:
        fa.set_attention_softmax_dtype("float32")
    torch.testing.assert_close(off, fa._torch_attention_mh_xla(q, k, v, 8, q.dtype),
                               rtol=0, atol=0)
    assert card["k1"].calls == 1
    with pytest.raises(ValueError, match="unknown attention softmax dtype"):
        fa.set_attention_softmax_dtype("float16")
    assert inside.shape == q.shape


def test_launch_still_refuses_shapes_outside_the_domain():
    """``_launch`` checks before it builds: a bad shape raises ValueError with no nvcc."""
    q = torch.zeros(2, 5, 128)
    with pytest.raises(ValueError, match="head dim"):
        fa._launch(q, q, q, 8)
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_bwd(q, q, q, q, 8)
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_split(*(t.view(2, 5, 8, 16).transpose(1, 2) for t in (q, q, q)))
    with pytest.raises(ValueError, match="head dim"):  # head dim 64: K1's, not K2's
        fa._launch_bwd(q, q, q, q, 2)
    x = torch.zeros(2, 5, 1056)
    with pytest.raises(ValueError, match="C <= 1024"):
        ld._launch(x, torch.ones(1056), torch.zeros(1056), [torch.zeros(64, 1056)], [None],
                   1e-5, torch.float32, [None])
    x = torch.zeros(2, 5, 320)  # K3's, not K4's
    with pytest.raises(ValueError, match="C <= 256"):
        ld._launch_bwd(x, torch.ones(320), torch.zeros(320), [torch.zeros(64, 320)], [None],
                       [torch.zeros(2, 5, 64)], 1e-5, torch.float32, [None])
    with pytest.raises(ValueError, match="O <= 256"):
        lm._launch(q, torch.ones(128), torch.zeros(128), torch.zeros(512, 128),
                   torch.zeros(512), torch.zeros(512, 512), torch.zeros(512), 1e-5,
                   torch.float32, None)


H100_CLUSTERS = (132, 66, 39, 30)  # clusters of 1-4 one-block-an-SM blocks an H100 ran at once


@pytest.mark.parametrize("softmax,nk,heads,want", [
    ("float32", 643, 8, (32, 0, 0, 0)),      # the default mode takes no plan
    ("bfloat16", 643, 8, (32, 1, 6, 112)),   # one pass: 6 warps of 112 keys, the last 83
    ("bfloat16", 1025, 8, (32, 1, 9, 128)),  # 9 warps of 128 keys, the last 1
    ("bfloat16", 4000, 8, (32, 1, 0, 0)),    # past 1152 keys: the two-sweep loop
    ("float32", 1281, 4, ("attention_mh64", 4, 0, 0, 4)),  # head dim 64: its own kernel,
                                                             # with a scratch for the bf16
                                                             # copies; 4 query tiles: keys
                                                             # split over 4
    ("bfloat16", 257, 4, ("attention_mh64", 4, 0, 1, 1)),  # and its exp mode, unsplit
    ("bfloat16", 1281, 4, ("attention_mh64", 4, 0, 1, 4)),  # the exp mode split over 4
])
def test_k1_launch_hands_the_kernel_its_exp_plan(monkeypatch, softmax, nk, heads, want):
    """K1's launch passes (head_dim, bf16_exp, splits, slice) from ``fa._exp_plan``; the
    kernel is stood in for by a function that records them. Head dim 64 launches
    ``attention_mh64.cu`` instead, in either mode and never ``attention_mh.cu``, with (heads,
    is_bf16, bf16_exp, splits) on an H100's cluster capacity."""
    seen = []

    def kernel(*args):
        seen.append((args[8],) + args[10:13])
        return 0

    def kernel64(*args):
        assert args[4] is not None  # fp32 inputs: the scratch of their bf16 copies
        seen.append(("attention_mh64",) + args[8:12])
        return 0

    monkeypatch.setattr(fa, "_kernel_fn", lambda: kernel)
    monkeypatch.setattr(fa, "_kernel64_fn", lambda: kernel64)
    monkeypatch.setattr(fa, "_k1_64_capacity", lambda device: H100_CLUSTERS)
    monkeypatch.setattr(fa._native, "stream", lambda device: 0)
    monkeypatch.setattr(fa.torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(fa, "launches", 0)
    q, kv = torch.zeros(1, 3, 256), torch.zeros(1, nk, 256)
    fa.set_attention_softmax_dtype(softmax)
    try:
        fa._launch(q, kv, kv, heads)
    finally:
        fa.set_attention_softmax_dtype("float32")
    assert seen == [want] and fa.launches == 1


def test_product_weight_is_cast_once_a_version():
    w = torch.nn.Parameter(torch.randn(64, 32))
    first = ld._product_weight(w)
    assert first.dtype == torch.bfloat16 and torch.equal(first, w.detach().bfloat16())
    assert ld._product_weight(w) is first  # unchanged: the same copy
    with torch.no_grad():
        w.mul_(2.0)  # an in-place update moves the version
    second = ld._product_weight(w)
    assert second is not first and torch.equal(second, w.detach().bfloat16())
    with torch.no_grad():
        w.copy_(torch.randn(64, 32))
    assert torch.equal(ld._product_weight(w), w.detach().bfloat16())


def test_ln_mlp_bf16_launch_takes_the_cached_weight_copies(monkeypatch):
    """K5's bf16 launch hands the kernel W1 and W2 from ``ld._product_weight``'s cache: cast
    on the first call, the same copies on the second, cast again after an in-place update;
    an fp32 launch hands it the fp32 weights themselves. The kernel is stood in for by a
    function that records the weight pointers it is given."""
    seen = []

    def kernel(*args):
        seen.append((args[3], args[5]))  # w1, w2
        return 0

    monkeypatch.setattr(lm, "_kernel_fn", lambda: kernel)
    monkeypatch.setattr(lm._native, "stream", lambda device: 0)
    monkeypatch.setattr(lm.torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(lm, "launches", 0)
    g = torch.Generator().manual_seed(3)
    w1 = torch.nn.Parameter(torch.randn(1024, 256, generator=g) / 16)
    w2 = torch.nn.Parameter(torch.randn(256, 1024, generator=g) / 32)
    x = torch.randn(2, 5, 256, generator=g)

    def launch(dtype):
        return lm._launch(x, torch.ones(256), torch.zeros(256), w1, torch.zeros(1024), w2,
                          torch.zeros(256), 1e-5, dtype, "gelu_tanh")

    launch(torch.bfloat16)  # a miss: both weights cast
    c1, c2 = ld._W_BF16[w1][1], ld._W_BF16[w2][1]
    assert seen[0] == (c1.data_ptr(), c2.data_ptr())
    assert torch.equal(c1, w1.detach().bfloat16()) and torch.equal(c2, w2.detach().bfloat16())
    launch(torch.bfloat16)  # a hit: the same copies
    assert seen[1] == seen[0] and ld._W_BF16[w1][1] is c1 and ld._W_BF16[w2][1] is c2
    with torch.no_grad():
        w1.mul_(2.0)  # an in-place update of W1 moves its version; W2 is untouched
    launch(torch.bfloat16)
    n1 = ld._W_BF16[w1][1]
    assert n1 is not c1 and torch.equal(n1, w1.detach().bfloat16())
    assert seen[2] == (n1.data_ptr(), c2.data_ptr())
    launch(torch.float32)  # the fp32 path reads the fp32 weights
    assert seen[3] == (w1.data_ptr(), w2.data_ptr())
    assert lm.launches == 4


def test_ln_mlp_wide_fp32_launch_takes_the_split_weights(monkeypatch):
    """K5's wide rows in fp32 hand the kernel each weight's TF32 parts ([2, ...]: hi, lo) from
    ``lm._split_weight``'s cache: split on the first call, the same parts on the second, split
    again after an in-place update; the parts are ``round_tf32`` of w and of w - hi, and sum
    back to w within fp32's rounding. The kernel is stood in for by a recording function."""
    seen = []

    def kernel(*args):
        seen.append((args[3], args[5]))  # w1, w2
        return 0

    monkeypatch.setattr(lm, "_kernel_fn", lambda: kernel)
    monkeypatch.setattr(lm._native, "stream", lambda device: 0)
    monkeypatch.setattr(lm.torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(lm, "launches", 0)
    g = torch.Generator().manual_seed(4)
    w1 = torch.nn.Parameter(torch.randn(1536, 384, generator=g) / 20)
    w2 = torch.nn.Parameter(torch.randn(384, 1536, generator=g) / 40)
    x = torch.randn(3, 384, generator=g)

    def launch():
        return lm._launch(x, torch.ones(384), torch.zeros(384), w1, torch.zeros(1536), w2,
                          torch.zeros(384), 1e-5, torch.float32, "gelu")

    launch()
    p1, p2 = lm._W_TF32[w1][1], lm._W_TF32[w2][1]
    assert seen[0] == (p1.data_ptr(), p2.data_ptr())
    for w, parts in ((w1, p1), (w2, p2)):
        assert parts.shape == (2,) + w.shape and parts.is_contiguous()
        assert (parts.view(torch.int32) & 0x1FFF).eq(0).all()  # both parts in TF32
        assert (parts[0] + parts[1] - w.detach()).abs().max() <= 2 ** -20 * w.abs().max()
    launch()
    assert seen[1] == seen[0] and lm._W_TF32[w1][1] is p1
    with torch.no_grad():
        w2.add_(1.0)
    launch()
    assert lm._W_TF32[w2][1] is not p2 and seen[2] == (p1.data_ptr(),
                                                         lm._W_TF32[w2][1].data_ptr())
    assert lm.launches == 3


def test_product_weight_follows_an_adamw_step():
    model = torch.nn.Linear(32, 64)
    state = create_train_state(model, lr=1e-2, device="cpu")
    before = ld._product_weight(model.weight)
    model(torch.randn(4, 32)).square().sum().backward()
    state.apply_gradients()
    after = ld._product_weight(model.weight)
    assert not torch.equal(after, before)
    assert torch.equal(after, model.weight.detach().bfloat16())


def test_product_weight_of_an_inference_tensor_is_not_kept():
    with torch.inference_mode():
        w = torch.randn(64, 32)
        got = ld._product_weight(w)
    assert torch.equal(got, w.bfloat16()) and w not in ld._W_BF16


def test_product_weight_is_held_only_while_the_weight_lives():
    """The copy sits in a weak map beside the parameter, not on it: a pickled or
    state-dict'd parameter carries no copy, and the copy goes when the parameter does."""
    w = torch.nn.Parameter(torch.randn(64, 32))
    ld._product_weight(w)
    assert w in ld._W_BF16 and not vars(w)
    before = len(ld._W_BF16)
    del w
    gc.collect()
    assert len(ld._W_BF16) == before - 1


H100_SLOTS = {torch.bfloat16: 2 * 132, torch.float32: 132}  # two or one block an SM, 132 SMs


@pytest.mark.parametrize("rows,fs,dtype,want", [
    (64 * 643, (1024,), torch.bfloat16, 4),          # z fc1: 322 row tiles on 264 slots
    (64 * 1024, (1024,), torch.bfloat16, 1),         # x fc1: 512 row tiles, ~2 full waves
    (64 * 643, (256, 256, 256), torch.bfloat16, 3),
    (32 * 643, (1024,), torch.float32, 4),           # 161 row tiles on 132 slots
    (37, (64,), torch.float32, 1),                   # one partial 128-column tile
])
def test_column_groups(rows, fs, dtype, want):
    """On an H100's tiling (128-row blocks, 128-column tiles; what the kernel's
    ``pcdiff_ln_denses_tiling`` reports there)."""
    got = ld._groups(rows, fs, 128, 128, H100_SLOTS[dtype], ld._LN_TILES[dtype])
    tiles = sum(-(-f // 128) for f in fs)
    assert got == want and 1 <= got <= tiles
