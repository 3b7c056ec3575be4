"""The port's flash attention (``repro_torch.kernels.flash_attention`` and
the autograd op in ``repro_torch.kernels.ops``) held to the JAX package's
Pallas flash kernels, run in interpret mode as tests/test_kernels.py runs
them, and to the port's own one-softmax oracle.

On the CPU the kernel wrappers run their plain torch versions, so these
tests pin the arithmetic the CUDA kernels are held to on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``). Inputs come from a
numpy seed. Outputs are compared over query rows with at least one live
key: a row with none is o = 0 in the port, the mean of V in Pallas (it
counts masked keys into the softmax sum), and never occurs in training.
Tolerances: fp32 o/lse atol 1e-5 and grads atol 1e-4 (both sides fp32;
block order and GQA summation order differ); bf16 inputs give bf16 o/dq/
dk/dv on both sides, within 1e-2 (about two bf16 ulps at unit scale).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

_STATIC = ("causal", "q_offset", "window", "attn_softcap", "scale")
j_fwd = jax.jit(functools.partial(jfa.flash_attention_fwd, interpret=True),
                static_argnames=_STATIC)
j_bwd = jax.jit(functools.partial(jfa.flash_attention_bwd, interpret=True),
                static_argnames=_STATIC)

# (B, Hq, Hkv, Tq, Tkv, D, causal, window, softcap, dtype): the case table
# of tests/test_kernels.py, then q_offset > 0 with kv_len per row
CASES = [
    (1, 2, 2, 128, 128, 64, True, None, None, "float32"),
    (2, 4, 2, 128, 256, 64, True, None, None, "bfloat16"),
    (1, 8, 2, 256, 256, 128, True, None, 50.0, "bfloat16"),
    (2, 2, 1, 128, 384, 64, True, 100, None, "float32"),
    (1, 4, 4, 64, 512, 64, False, None, None, "float32"),
    (2, 4, 2, 100, 300, 64, True, None, None, "float32"),
]
RAGGED = (2, 4, 2, 200, 300, 64, True, 150, 30.0, "float32")

BWD_CASES = [
    (1, 2, 2, 128, 128, 64, True, None, None, "float32"),
    (2, 4, 2, 128, 256, 64, True, None, None, "float32"),
    (1, 4, 2, 128, 128, 64, True, None, 30.0, "float32"),
    (1, 2, 1, 128, 256, 64, True, 64, None, "float32"),
    RAGGED,
]


def _inputs(case, seed):
    b, hq, hkv, tq, tkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, hq, tq, d), (b, hkv, tkv, d), (b, hkv, tkv, d),
             (b, hq, tq, d))]


def _kw(case, ragged):
    b, _, _, tq, tkv, _, causal, window, cap, _ = case
    kw = dict(causal=causal, q_offset=tkv - tq, window=window,
              attn_softcap=cap)
    kv_len = [tkv - 7, tkv - 61][:b] if ragged else [tkv - 7] * b
    return kw, np.asarray(kv_len, np.int32)


def _jax(x, dtype):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _live_rows(case, kw, kv_len):
    """[B, Tq] query rows with at least one live key."""
    _, _, _, tq, tkv, _ = case[:6]
    qpos = np.arange(tq)[None, :, None] + kw["q_offset"]
    kpos = np.arange(tkv)[None, None, :]
    ok = (kpos < kv_len[:, None, None]) & np.ones((1, tq, 1), bool)
    if kw["causal"]:
        ok = ok & (kpos <= qpos)
    if kw["window"] is not None:
        ok = ok & (kpos > qpos - kw["window"])
    return ok.any(-1)


def _close(got, want, live, dtype, atol):
    got, want = _np(got), _np(want)
    if live is not None:
        got, want = got.transpose(0, 2, 1, 3)[live], \
            want.transpose(0, 2, 1, 3)[live]
    tol = 1e-2 if dtype == "bfloat16" else atol
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol if
                               dtype == "bfloat16" else 0)


@pytest.mark.parametrize("i", range(len(CASES) + 1))
def test_flash_forward_matches_jax_kernel(i):
    case = CASES[i] if i < len(CASES) else RAGGED
    dtype = case[-1]
    kw, kv_len = _kw(case, ragged=i == len(CASES))
    q, k, v, _ = _inputs(case, i)
    jo, jlse = j_fwd(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                     kv_len=jnp.asarray(kv_len), **kw)
    to, tlse = tfa.flash_attention_fwd(_torch(q, dtype), _torch(k, dtype),
                                       _torch(v, dtype),
                                       kv_len=torch.from_numpy(kv_len), **kw)
    assert to.dtype == getattr(torch, dtype) and tlse.dtype == torch.float32
    live = _live_rows(case, kw, kv_len)
    _close(to, jo, live, dtype, 1e-5)
    lse_live = np.broadcast_to(live[:, None], tlse.shape)
    np.testing.assert_allclose(_np(tlse)[lse_live], _np(jlse)[lse_live],
                               atol=1e-5)


@pytest.mark.parametrize("i", range(len(BWD_CASES)))
def test_flash_backward_matches_jax_kernel(i):
    """dq, dk, dv of the plain backward against the Pallas backward, both
    from the Pallas forward's (o, lse)."""
    case = BWD_CASES[i]
    dtype = case[-1]
    kw, kv_len = _kw(case, ragged=case is RAGGED)
    q, k, v, do = _inputs(case, 100 + i)
    jq, jk, jv, jdo = (_jax(x, dtype) for x in (q, k, v, do))
    jo, jlse = j_fwd(jq, jk, jv, kv_len=jnp.asarray(kv_len), **kw)
    jdq, jdk, jdv = j_bwd(jq, jk, jv, jo, jlse, jdo,
                          kv_len=jnp.asarray(kv_len), **kw)
    tq_, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    dq, dk, dv = tfa.flash_attention_bwd(
        tq_, tk, tv, _torch(np.array(jo, np.float32), dtype),
        torch.from_numpy(np.array(jlse)), tdo,
        kv_len=torch.from_numpy(kv_len), **kw)
    live = _live_rows(case, kw, kv_len)
    _close(dq, jdq, live, dtype, 1e-4)
    _close(dk, jdk, None, dtype, 1e-4)
    _close(dv, jdv, None, dtype, 1e-4)


@pytest.mark.parametrize("i", range(len(BWD_CASES)))
def test_flash_autograd_matches_oracle_autodiff(i):
    """The autograd op (plain fwd + plain bwd on CPU tensors) against torch
    autograd of ``flash_attention_ref``, as
    ``test_flash_backward_matches_autodiff`` holds the Pallas op; in the
    model's [B,T,H,D] layout, as ``attend(impl="kernel")`` calls it."""
    case = BWD_CASES[i]
    kw, kv_len = _kw(case, ragged=case is RAGGED)
    if case is not RAGGED:
        kv_len = None
    q, k, v, _ = _inputs(case, 200 + i)

    def grads(fn):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*ts).float() ** 2).sum().backward()
        return [t.grad for t in ts]

    kl = None if kv_len is None else torch.from_numpy(kv_len)
    g_op = grads(lambda q_, k_, v_: tops.flash_attention(
        q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
        kv_len=kl, **kw).transpose(1, 2))
    g_ref = grads(lambda q_, k_, v_: tref.flash_attention_ref(
        q_, k_, v_, kv_len=kl, **kw)[0])
    for a, b_ in zip(g_op, g_ref):
        np.testing.assert_allclose(_np(a), _np(b_), atol=1e-4)


def test_flash_oracle_matches_jax_oracle():
    """The port's ``flash_attention_ref`` against the JAX ``ref.py`` one on
    the ragged case (o and lse)."""
    from repro.kernels import ref as jref
    kw, kv_len = _kw(RAGGED, ragged=True)
    q, k, v, _ = _inputs(RAGGED, 7)
    jo, jlse = jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(kv_len), **kw)
    to, tlse = tref.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-5)
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=1e-5)


def test_flash_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run their plain versions and count no
    launch, of any kernel; ``flash_attention_bwd`` composes the two
    backward wrappers."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(CASES[0], 3))
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    counts = [(n, c) for n in names for c in ("launches", "sm90_launches")]
    before = [getattr(getattr(tfa, n), c) for n, c in counts]
    o, lse = tfa.flash_attention_fwd(q, k, v)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    assert [getattr(getattr(tfa, n), c) for n, c in counts] == before
    delta = (do * o).sum(-1)
    torch.testing.assert_close(
        dq, tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta))
    for a, b_ in zip((dk, dv), tfa.flash_attention_bwd_dkv_plain(
            q, k, v, do, lse, delta)):
        torch.testing.assert_close(a, b_)


# ------------------------------------ the fp32 kernels' error budget --
# (B, Hq, Hkv, T, D, [B,T,H,D] layout, options): the causal training
# geometry at T 512, and a ragged case
BUDGET_CASES = {
    "causal": (1, 4, 2, 512, 128, True, dict(causal=True)),
    "ragged": (2, 4, 2, 300, 128, False,
               dict(causal=True, q_offset=24, kv_len=[300, 231], window=128,
                    attn_softcap=50.0)),
}


def _budget_inputs(name):
    """(q, k, v, do) of a BUDGET_CASES case in fp32 from a numpy seed, and
    its options."""
    b, hq, hkv, t, d, bthd, kw = BUDGET_CASES[name]
    rng = np.random.default_rng(11)

    def mk(h):
        x = rng.standard_normal((b, t, h, d) if bthd else (b, h, t, d))
        x = torch.from_numpy(x.astype(np.float32))
        return x.transpose(1, 2) if bthd else x

    kw = dict(kw)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"])
    return (mk(hq), mk(hkv), mk(hkv), mk(hq)), kw


def _in_float64(monkeypatch, fn):
    """``fn()`` with the plain versions' fp32 arithmetic in float64: their
    ``.float()`` casts and the fp32 buffers they make."""
    made = {name: getattr(torch, name) for name in ("zeros", "full")}

    def wide(make):
        return lambda *a, dtype=None, **k_: make(
            *a, dtype=torch.float64 if dtype == torch.float32 else dtype,
            **k_)

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        for name, make in made.items():
            mp.setattr(torch, name, wide(make))
        return fn()


def _rel_errs(out, ref, masks):
    """max |out - ref| / max |ref| of each output over its mask."""
    return [((x.double() - r)[m].abs().max() / r[m].abs().max()).item()
            for x, r, m in zip(out, ref, masks)]


@pytest.mark.parametrize("name", sorted(BUDGET_CASES))
def test_flash_bwd_tf32x3_error_budget(name, monkeypatch):
    """The fp32 dq and dk/dv kernels (``csrc/flash_attention.cu``) form
    every product in 3xTF32 on the tensor cores. The plain versions with
    every product made that way (``torch.einsum`` is each product of
    ``_scores`` and ``_bwd_blocks``) stay within the card's fp32 gate of a
    float64 run of the plain versions on the same inputs, and within 4x
    of the plain fp32 versions' own error there."""
    from repro_torch.kernels import cascade_cases
    (q, k, v, do), kw = _budget_inputs(name)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do * o).sum(-1)
    live = lse > -1e29

    def run(dtype):
        args = [x.to(dtype) for x in (q, k, v, do, lse, delta)]
        return (tfa.flash_attention_bwd_dq_plain(*args, **kw),
                *tfa.flash_attention_bwd_dkv_plain(*args, **kw))

    ref = _in_float64(monkeypatch, lambda: run(torch.float64))
    assert all(x.dtype == torch.float64 for x in ref)
    masks = (live, True, True)     # dq over rows with a live key
    fp32 = _rel_errs(run(torch.float32), ref, masks)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "einsum", cascade_cases.einsum_3xtf32)
        emu = _rel_errs(run(torch.float32), ref, masks)
    tol = cascade_cases.TOL_FLASH[torch.float32]
    assert all(e <= tol for e in emu), (emu, fp32)
    assert all(e <= 4 * f for e, f in zip(emu, fp32)), (emu, fp32)


@pytest.mark.parametrize("name", sorted(BUDGET_CASES))
def test_flash_fwd_tf32x3_error_budget(name, monkeypatch):
    """The fp32 forward kernel forms S = (Q*scale) K^T and O += P V in
    3xTF32 on the tensor cores. The plain forward with both products made
    that way keeps o (rows with a live key) within the card's fp32 gate of
    a float64 run of the plain forward on the same inputs and within 4x of
    the plain fp32 forward's own error there, and lse within ``TOL_LSE``
    of the float64 one."""
    from repro_torch.kernels import cascade_cases
    (q, k, v, _), kw = _budget_inputs(name)

    def run(dtype):
        return tfa.flash_attention_fwd_plain(
            *(x.to(dtype) for x in (q, k, v)), **kw)

    o_ref, lse_ref = _in_float64(monkeypatch, lambda: run(torch.float64))
    assert o_ref.dtype == lse_ref.dtype == torch.float64
    live = lse_ref > -1e29
    assert live.any()
    o32, _ = run(torch.float32)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "einsum", cascade_cases.einsum_3xtf32)
        o_emu, lse_emu = run(torch.float32)
    (fp32,) = _rel_errs([o32], [o_ref], [live])
    (emu,) = _rel_errs([o_emu], [o_ref], [live])
    assert emu <= cascade_cases.TOL_FLASH[torch.float32], (emu, fp32)
    assert emu <= 4 * fp32, (emu, fp32)
    lse_err = (lse_emu.double() - lse_ref)[live].abs().max().item()
    assert lse_err <= cascade_cases.TOL_LSE, lse_err


def test_attend_kernel_refuses_extra_mask():
    """JAX ``attend(impl="pallas")`` drops ``extra_mask`` (a reference
    quirk, ROADMAP queue 3); the port raises instead. Smallest case: two
    tokens, one head, D 1, q = k = 1, v = (0, 1), an identity mask: the
    masked answer for token 1 is 1.0, Pallas returns the causal 0.5."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    q = np.ones((1, 2, 1, 1), np.float32)
    v = np.array([0.0, 1.0], np.float32).reshape(1, 2, 1, 1)
    eye = np.eye(2, dtype=bool)
    got = jattn.attend(q, q, v, impl="pallas", extra_mask=eye)
    np.testing.assert_allclose(np.asarray(got).ravel(), [0.0, 0.5])
    np.testing.assert_allclose(np.asarray(jattn.attend(
        q, q, v, impl="dense", extra_mask=eye)).ravel(), [0.0, 1.0])
    with pytest.raises(ValueError, match="extra_mask"):
        tattn.attend(torch.from_numpy(q), torch.from_numpy(q),
                     torch.from_numpy(v), impl="kernel",
                     extra_mask=torch.from_numpy(eye))
