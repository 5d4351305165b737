"""The port's flash-attention and chunked-SSD kernel modules.

On the CPU each kernel wrapper runs its plain version, so these tests hold
the plain versions against the JAX Pallas kernels run in interpret mode,
as the reference's own kernel tests run them, on the same cases and at
the same tolerances (``tests/test_kernels.py``); and check the wrappers'
input validation and the ptxas parsing of their builds.  The CUDA kernels
themselves are compared with their plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention as j_attention
from repro.kernels.ssd import ssd as j_ssd
from repro.kernels.ssd import ssd_ref as j_ssd_ref
from repro.kernels.ssd.kernel import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel

torch.set_num_threads(1)

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return (dict(rtol=2e-5, atol=2e-5) if dtype == jnp.float32
            else dict(rtol=2e-2, atol=2e-2))


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.as_tensor(np.array(j, np.float32)).to(_TORCH[dtype])
    return j, t


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # B, Hq, Hkv, Lq, Lk, D, causal, window, bq, bk
    (2, 4, 2, 64, 64, 16, True, None, 16, 16),
    (1, 6, 2, 32, 32, 32, True, 24, 16, 16),
    (2, 4, 4, 16, 64, 16, True, None, 16, 16),    # decode: Lq < Lk
    (1, 2, 1, 64, 64, 8, False, None, 32, 16),
    (1, 8, 1, 128, 128, 16, True, 32, 32, 32),    # MQA + SWA
    (1, 4, 2, 64, 64, 80, True, 48, 16, 16),      # danube's head size
    (2, 4, 4, 32, 32, 80, False, None, 16, 16),   # hubert's: MHA, encoder
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_matches_pallas_interpret(case, dtype):
    B, Hq, Hkv, Lq, Lk, D, causal, window, bq, bk = case
    rng = np.random.default_rng(Lq + D)
    jq, tq = _pair(rng.standard_normal((B, Hq, Lq, D)), dtype)
    jk, tk = _pair(rng.standard_normal((B, Hkv, Lk, D)), dtype)
    jv, tv = _pair(rng.standard_normal((B, Hkv, Lk, D)), dtype)
    want = j_attention(jq, jk, jv, causal=causal, window=window,
                       block_q=bq, block_k=bk, interpret=True)
    before = fa_kernel.launch_count()
    got = tfa.attention(tq, tk, tv, causal=causal, window=window)
    assert fa_kernel.launch_count() == before     # CPU: plain version only
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_flash_attention_validation():
    q = torch.zeros(1, 4, 16, 16)
    k = torch.zeros(1, 2, 16, 16)
    bad = {
        "float32 or bfloat16": (q.double(), k.double(), k.double()),
        "D in": (torch.zeros(1, 4, 16, 24), torch.zeros(1, 2, 16, 24),
                 torch.zeros(1, 2, 16, 24)),
        "multiple of Hkv": (torch.zeros(1, 3, 16, 16), k, k),
        "align to the end": (torch.zeros(1, 4, 32, 16), k, k),
        "k and v must be": (q, k, torch.zeros(1, 2, 8, 16)),
        "must be contiguous": (q.transpose(2, 3), k, k),
        "q is": (q, k.bfloat16(), k),
    }
    for match, (a, b, c) in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            fa_kernel._check(a, b, c)
    fa_kernel._check(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_kernel.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    # the reference's 128-row blocking precondition
    with pytest.raises(ValueError, match="multiple of 128"):
        tfa.attention(torch.zeros(1, 4, 200, 16), torch.zeros(1, 2, 200, 16),
                      torch.zeros(1, 2, 200, 16))


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(shape, dtype):
    b, L, H, P, G, S, chunk = shape
    rng = np.random.default_rng(L + H)
    return [_pair(a, dtype) for a in (
        rng.standard_normal((b, L, H, P)),
        rng.uniform(0.01, 0.2, (b, L, H)),
        -rng.uniform(0.2, 1.5, (H,)),
        rng.standard_normal((b, L, G, S)),
        rng.standard_normal((b, L, G, S)),
        rng.standard_normal((H,)))]


@pytest.mark.parametrize("shape", [
    # b, L, H, P, G, S, chunk
    (2, 64, 4, 16, 1, 8, 16),
    (1, 48, 6, 32, 2, 16, 16),
    (2, 33, 2, 8, 1, 4, 8),       # unaligned L -> padding path
    (1, 128, 2, 64, 1, 64, 64),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_plain_versions_match_pallas_interpret(shape, dtype):
    """Both plain versions -- the chunked one behind the op (``ssd``) and
    the sequential oracle (``ssd_ref``) -- against the Pallas kernel."""
    chunk = shape[-1]
    pairs = _ssd_inputs(shape, dtype)
    j_args = [p[0] for p in pairs]
    t_args = [p[1] for p in pairs]
    # The op's casts: A is float32 in the model (-exp(A_log in float32)).
    j_args[2], t_args[2] = j_args[2].astype(jnp.float32), t_args[2].float()
    pallas = j_ssd(*j_args, chunk=chunk, interpret=True)
    before = ssd_kernel.launch_count()
    chunked = tssd.ssd(*t_args, chunk=chunk)
    assert ssd_kernel.launch_count() == before    # CPU: plain version only
    seq = tssd.ssd_ref(*t_args)
    assert chunked.dtype == seq.dtype == t_args[0].dtype
    if dtype == jnp.bfloat16:
        # bf16: the chunked paths accumulate in float32 and round once,
        # the sequential ones round per step -- judge every version
        # against the float32 oracle at bf16 resolution of the output.
        f32 = [a.astype(jnp.float32) for a in j_args]
        want = _np(j_ssd_ref(*f32))
        atol = 0.04 * float(np.abs(want).max())
        for got in (pallas, chunked, seq):
            np.testing.assert_allclose(_np(got), want, atol=atol)
    else:
        for got in (chunked, seq):
            np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


def test_ssd_chunked_plain_matches_pallas_kernel_function():
    """The kernel's own interface, (l, dtx, B, C) -> y, against the Pallas
    kernel function, across chunks that carry state."""
    rng = np.random.default_rng(7)
    BH, L, P, S, chunk = 4, 64, 16, 8, 16
    l = -rng.uniform(0.0, 0.3, (BH, L))
    dtx, B, C = (rng.standard_normal(s) for s in
                 ((BH, L, P), (BH, L, S), (BH, L, S)))
    want = jax.jit(lambda *a: j_ssd_chunked(*a, chunk=chunk,
                                            interpret=True))(
        *(jnp.asarray(a, jnp.float32) for a in (l, dtx, B, C)))
    got = ssd_kernel.ssd_chunked(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (l, dtx, B, C)),
        chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_ssd_validation():
    l = torch.zeros(2, 32)
    x = torch.zeros(2, 32, 16)
    Bm = torch.zeros(2, 32, 8)
    bad = {
        "l must be float32": (l.double(), x, Bm, Bm, 16),
        "float32 or bfloat16": (l, x.double(), Bm.double(), Bm.double(), 16),
        "P in": (l, torch.zeros(2, 32, 12), Bm, Bm, 16),
        "S <= 128": (l, x, torch.zeros(2, 32, 130), torch.zeros(2, 32, 130),
                     16),
        "chunk <= 256": (l, x, Bm, Bm, 512),
        "multiple of chunk": (l, x, Bm, Bm, 12),
        "C must be": (l, x, Bm, torch.zeros(2, 32, 4), 16),
        "B is": (l, x, Bm.bfloat16(), Bm, 16),
        "must be contiguous": (l, x.transpose(0, 1).contiguous()
                               .transpose(0, 1), Bm, Bm, 16),
    }
    for match, (a, b, c, d, q) in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            ssd_kernel._check(a, b, c, d, q)
    ssd_kernel._check(l, x, Bm, Bm, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_chunked(l.to("meta"), x.to("meta"), Bm.to("meta"),
                               Bm.to("meta"), chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_kernel.ssd_chunked(l, x, Bm, Bm, chunk=12)


# ---------------------------------------------------------------------------
# the arithmetic of the tensor-core designs
# ---------------------------------------------------------------------------

# (BH, L, P, S, chunk, tail): the reference's four test shapes on the
# kernel's operands (heads folded in; the third is L = 33 padded to 40 by
# the op), and one with a dt = 0 padded tail of 7 steps.
STAGED_SHAPES = [
    (8, 64, 16, 8, 16, 0),
    (6, 48, 32, 16, 16, 0),
    (4, 40, 8, 4, 8, 7),
    (2, 128, 64, 64, 64, 0),
    (3, 48, 16, 8, 16, 7),
]


def _staged_inputs(shape):
    """Kernel operands from a seeded numpy generator; the last ``tail``
    steps are what ``ops.ssd``'s padding gives (l, dtx, B, C all 0)."""
    BH, L, P, S, chunk, tail = shape
    rng = np.random.default_rng(BH * L + P + S)
    l = -rng.uniform(0.0, 0.3, (BH, L))
    dtx, B, C = (rng.standard_normal(s) for s in
                 ((BH, L, P), (BH, L, S), (BH, L, S)))
    for a in (l, dtx, B, C):
        a[:, L - tail:] = 0.0
    return l, dtx, B, C


@pytest.mark.parametrize("shape", STAGED_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_staged_ref_matches_chunked_and_pallas(shape, dtype):
    """The three stages of the chunk-parallel kernel, in plain torch,
    against the port's chunked plain version and the Pallas kernel in
    interpret mode: float32 at 2e-5 (of max |want| against Pallas),
    bfloat16 at 0.04 x max |want|."""
    chunk = shape[4]
    l, dtx, B, C = _staged_inputs(shape)
    jl = jnp.asarray(l, jnp.float32)
    jx, tx = zip(*(_pair(a, dtype) for a in (dtx, B, C)))
    tl = torch.as_tensor(l, dtype=torch.float32)
    got, states = tssd.ssd_staged_ref(tl, *tx, chunk=chunk)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    assert states.shape == (shape[0], shape[1] // chunk, shape[2], shape[3])
    assert bool((states[:, 0] == 0).all())
    chunked = tssd.ssd_chunked_ref(tl, *tx, chunk=chunk)
    pallas = j_ssd_chunked(jl, *jx, chunk=chunk, interpret=True)
    if dtype == jnp.float32:
        np.testing.assert_allclose(_np(got), _np(chunked), rtol=2e-5,
                                   atol=2e-5)
        # Against Pallas, normwise (the rule of chip_smoke.py's SSD check):
        # an output sums up to chunk x S products of terms much larger
        # than the smallest outputs, in another order.
        want = _np(pallas)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-5 * float(np.abs(want).max()))
    else:
        for want in (_np(chunked), _np(pallas)):
            atol = 0.04 * float(np.abs(want).max())
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", STAGED_SHAPES)
def test_ssd_bf16_split_keeps_float32_error(shape):
    """On bf16 operand values, the kernel's hi/lo split of its three
    float32 operands moves y and the chunk states by at most 1e-4 of their
    magnitude (a bf16 rounding of those operands would move them by
    ~4e-3).  Both runs return float32, so y's final bf16 rounding does not
    hide the difference."""
    chunk = shape[4]
    l, dtx, B, C = _staged_inputs(shape)
    tl = torch.as_tensor(l, dtype=torch.float32)
    tx = [torch.as_tensor(a, dtype=torch.float32).bfloat16().float()
          for a in (dtx, B, C)]
    y0, s0 = tssd.ssd_staged_ref(tl, *tx, chunk=chunk)
    y1, s1 = tssd.ssd_staged_ref(tl, *tx, chunk=chunk, split_bf16=True)
    for got, want in ((y1, y0), (s1, s0)):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5e4, 1e30])
def test_bf16_split_reproduces_float32(scale):
    """hi + lo reproduces float32 x to 2^-16 relative; hi alone does not."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = torch.as_tensor(rng.standard_normal(4096) * scale,
                        dtype=torch.float32)
    hi, lo = tssd.bf16_split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -16
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -16


def test_dispatch_rules():
    """The wrappers' dispatch: a plain function of dtype and head size."""
    for D in (16, 32, 64, 80, 128):
        assert fa_kernel.variant(torch.bfloat16, D) == "mma"
        assert fa_kernel.variant(torch.float32, D) == "simt"
    assert fa_kernel.variant(torch.bfloat16, 8) == "simt"
    assert fa_kernel.variant(torch.float32, 8) == "simt"
    for P in ssd_kernel.HEAD_DIMS:
        assert ssd_kernel.variant(torch.bfloat16, P) == "mma"
        assert ssd_kernel.variant(torch.float32, P) == "simt"
    for mod in (fa_kernel, ssd_kernel):
        assert set(mod.VARIANTS) == {"mma", "simt"}
        assert mod.launch_count() == sum(mod.launch_count(v)
                                         for v in mod.VARIANTS)


# ---------------------------------------------------------------------------
# builds (nothing is compiled here: there is no nvcc)
# ---------------------------------------------------------------------------

def test_no_build_at_import_and_ptxas_parse():
    for mod in (fa_kernel, ssd_kernel):
        assert mod.SOURCE.is_file() and mod._lib is None
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_"
        "attn_kernelILi64E13__nv_bfloat16EEvPKT0_S4_S4_PS2_iiiiiiif' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 122 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_"
        "attn_kernelILi8EfEEvPKT0_S3_S3_PS1_iiiiiiif' for 'sm_90a'\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n")
    assert fa_kernel._parse_ptxas(log) == [
        {"D": 64, "dtype": "bfloat16", "spill_stores": 0, "spill_loads": 0,
         "registers": 122},
        {"D": 8, "dtype": "float32", "spill_stores": 4, "spill_loads": 8,
         "registers": 40}]
    log = log.replace("17flash_attn_kernel", "16ssd_chunk_kernel")
    assert [(r["P"], r["dtype"]) for r in ssd_kernel._parse_ptxas(log)] == [
        (64, "bfloat16"), (8, "float32")]


def test_ptxas_parse_of_the_mma_kernels():
    for mod in (fa_kernel, ssd_kernel):
        assert mod.SOURCE_MMA.is_file() and mod._lib_mma is None
    entry = ("ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__8e6_"
             "{}' for 'sm_90a'\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
             "loads\nptxas info    : Used {} registers, used 1 barriers\n")
    log = (entry.format("21flash_attn_mma_kernelILi64EEEvPK13__nv_bfloat16S3_"
                        "S3_PS1_iiiiiiif", 129)
           + entry.format("21flash_attn_mma_kernelILi16EEEvPK13__nv_bfloat16"
                          "S3_S3_PS1_iiiiiiif", 77))
    assert [(r["D"], r["dtype"], r["registers"])
            for r in fa_kernel._parse_ptxas(log)] == [
        (16, "bfloat16", 77), (64, "bfloat16", 129)]
    log = (entry.format("21ssd_chunk_scan_kernelILi64EEEvPKfPK13__nv_bfloat16"
                        "S5_S5_S2_PS3_iiiiii", 86)
           + entry.format("22ssd_chunk_state_kernelEPKfPK13__nv_bfloat16S4_"
                          "PfS5_iiiii", 48)
           + entry.format("21ssd_state_pass_kernelEPKfPfiii", 32))
    assert [(r["stage"], r.get("PB"), r["registers"])
            for r in ssd_kernel._parse_ptxas(log)] == [
        ("chunk_scan", 64, 86), ("chunk_state", None, 48),
        ("state_pass", None, 32)]
