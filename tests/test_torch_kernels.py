"""The port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; that version is
held here against the JAX oracles (``kernels/*/ref.py``), the Pallas kernels
in interpret mode (as ``tests/test_kernels.py`` runs them) and the model
functions of ``repro/models/attention.py``, at fp32 atol 1e-5. The CUDA
kernels themselves are held against the plain versions by the tests marked
by the ``cuda`` fixture (skipped without a card) and by ``chip_smoke.py``.
"""
import itertools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.paged_attention.kernel import \
    paged_attention as pallas_slot  # noqa: E402
from repro.kernels.paged_attention.kernel import \
    paged_attention_global as pallas_global  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_global_ref as jax_global_ref  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_slot_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import (flash_attention_fwd, launch_counts,  # noqa: E402
                                 paged_attention_global, reset_launch_counts)
from repro_torch.kernels.flash_attention.ops import kernel_for  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    head_groups, n_splits, paged_attention, paged_decode, tokens_per_copy)
from repro_torch.kernels.paged_attention.precision import (  # noqa: E402
    cancellation_scores, decode_p_rounded, p_cancellation_case)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    gather_global_pages, gather_slot_pages, paged_attention_global_ref,
    paged_attention_ref)
from repro_torch.models import attention as tattn  # noqa: E402

ATOL = 1e-5
B, HQ, HKV, TOTAL, P, PAGE, D = 5, 8, 2, 16, 4, 8, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_inputs(seed=0):
    """Shared pages (rows 0/1 map pages 0, 1), NULL entries past each
    length, a length-0 row, a full row, and an inactive all-NULL row of
    length 1 (what ``paged_append`` leaves in an empty decode slot)."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, HQ, D)).astype(np.float32)
    kp = r.standard_normal((TOTAL, PAGE, HKV, D)).astype(np.float32)
    vp = r.standard_normal((TOTAL, PAGE, HKV, D)).astype(np.float32)
    tbl = np.array([[0, 1, 2, TOTAL],
                    [0, 1, 5, TOTAL],
                    [TOTAL] * 4,
                    [7, 8, 9, 10],
                    [TOTAL] * 4], np.int32)
    lens = np.array([3 * PAGE - 5, 2 * PAGE + 3, 0, 4 * PAGE, 1], np.int32)
    return q, kp, vp, tbl, lens


def _slot_inputs(seed=0):
    """Per-slot pools (B, P, PAGE, HKV, D) with a random permutation table
    per row; lengths: partial, a length-0 row, a full row, and 1."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, HQ, D)).astype(np.float32)
    kp = r.standard_normal((B, P, PAGE, HKV, D)).astype(np.float32)
    vp = r.standard_normal((B, P, PAGE, HKV, D)).astype(np.float32)
    tbl = np.stack([r.permutation(P) for _ in range(B)]).astype(np.int32)
    lens = np.array([3 * PAGE - 5, 2 * PAGE + 3, 0, 4 * PAGE, 1], np.int32)
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_plain_matches_jax_oracle(softcap):
    q, kp, vp, tbl, lens = _paged_inputs()
    out = paged_attention_global(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                                 softcap=softcap).numpy()
    ref = np.asarray(jax_global_ref(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                    softcap=softcap))
    live = [0, 1, 3, 4]            # the JAX oracle gives NaN at length 0
    np.testing.assert_allclose(out[live], ref[live], atol=ATOL)
    assert np.isnan(ref[2]).all() and (out[2] == 0).all()


@pytest.mark.parametrize("residency", ["smem", "hbm"])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_plain_matches_pallas_interpret(residency, softcap):
    q, kp, vp, tbl, lens = _paged_inputs(1)
    out = paged_attention_global(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                                 softcap=softcap).numpy()
    pal = np.asarray(pallas_global(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                   softcap=softcap, table_residency=residency,
                                   interpret=True))
    np.testing.assert_allclose(out[:4], pal[:4], atol=ATOL)
    # Row 4 (all NULL, length 1): the port reads a zero page; the Pallas
    # smem index map clamps NULL to page 0 and reads a live page's token.
    assert (out[4] == 0).all()
    if residency == "smem":
        assert not np.allclose(pal[4], 0)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_global_hbm_residency_matches_pallas_interpret(softcap):
    """The LLC-off baseline: pages gathered out of the shared pool, then the
    per-slot kernel on an identity table; every row, the all-NULL one
    included (the gather zeroes NULL pages on both sides)."""
    q, kp, vp, tbl, lens = _paged_inputs(6)
    out = paged_attention_global(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                                 softcap=softcap, table_residency="hbm")
    pal = np.asarray(pallas_global(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                   softcap=softcap, table_residency="hbm",
                                   interpret=True))
    np.testing.assert_allclose(out.numpy(), pal, atol=ATOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_slot_plain_matches_jax_oracle(softcap):
    q, kp, vp, tbl, lens = _slot_inputs()
    out = paged_attention(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                          softcap=softcap).numpy()
    ref = np.asarray(jax_slot_ref(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                  softcap=softcap))
    live = [0, 1, 3, 4]            # the JAX oracle gives NaN at length 0
    np.testing.assert_allclose(out[live], ref[live], atol=ATOL)
    assert np.isnan(ref[2]).all() and (out[2] == 0).all()


@pytest.mark.parametrize("residency", ["smem", "hbm"])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_slot_plain_matches_pallas_interpret(residency, softcap):
    q, kp, vp, tbl, lens = _slot_inputs(1)
    out = paged_attention(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                          softcap=softcap, table_residency=residency).numpy()
    pal = np.asarray(pallas_slot(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                 softcap=softcap, table_residency=residency,
                                 interpret=True))
    np.testing.assert_allclose(out, pal, atol=ATOL)
    assert (out[2] == 0).all()


def test_slot_entries_past_the_pool_read_zero_pages():
    """A table entry >= n_pages is a zero page, never an index."""
    q, kp, vp, tbl, lens = _slot_inputs(2)
    bad = tbl.copy()
    bad[0, 1] = P + 3
    kz, vz = kp.copy(), vp.copy()
    kz[0, tbl[0, 1]] = 0
    vz[0, tbl[0, 1]] = 0
    for residency in ("smem", "hbm"):
        out = paged_attention(_t(q), _t(kp), _t(vp), _t(bad), _t(lens),
                              table_residency=residency)
        ref = paged_attention(_t(q), _t(kz), _t(vz), _t(tbl), _t(lens))
        np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_paged_decode_dispatches_on_pool_rank():
    sq, skp, svp, stbl, slens = map(_t, _slot_inputs(3))
    gq, gkp, gvp, gtbl, glens = map(_t, _paged_inputs(3))
    assert torch.equal(paged_decode(sq, skp, svp, stbl, slens, softcap=20.0),
                       paged_attention_ref(sq, skp, svp, stbl, slens,
                                           softcap=20.0))
    assert torch.equal(paged_decode(gq, gkp, gvp, gtbl, glens),
                       paged_attention_global_ref(gq, gkp, gvp, gtbl, glens))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_plain_lse_is_the_logsumexp_of_the_scores(softcap):
    """The per-slot plain version's log-sum-exp (``return_lse``) against an
    fp32 logsumexp of each row's valid scores; the row of length 0 reads
    -inf; the output, in fp32, is the one without ``return_lse``."""
    q, kp, vp, tbl, lens = map(_t, _slot_inputs(11))
    out, lse = paged_attention(q, kp, vp, tbl, lens, softcap=softcap,
                               return_lse=True)
    assert torch.equal(out, paged_attention(q, kp, vp, tbl, lens,
                                            softcap=softcap))
    k = gather_slot_pages(kp, tbl).reshape(B, P * PAGE, HKV, D)
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, HKV, HQ // HKV, D),
                     k) * D ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.reshape(B, HQ, P * PAGE)
    want = torch.stack([torch.logsumexp(s[b, :, :n], dim=-1) if n else
                        torch.full((HQ,), float("-inf"))
                        for b, n in enumerate(lens.tolist())])
    assert lse.dtype == torch.float32 and lse.shape == (B, HQ)
    assert lens[2] == 0 and torch.isneginf(lse[2]).all()
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_pages", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_kernel_lse_matches_plain_on_card(cuda, dtype, n_pages):
    """The kernel's log-sum-exp against the plain version's, written by the
    CTA that writes the output (one split: a one-page table; else the last
    CTA's merge of several): rows of length 0 (-inf), 1, 7 and full; the
    output, then fp32, rounds to the one without it bit for bit."""
    dt = getattr(torch, dtype)
    page, hq_, hkv_, d_ = 16, 32, 8, 64
    lens = [0, 1, 7, n_pages * page]
    g = torch.Generator(device=cuda).manual_seed(n_pages)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=cuda).to(dt)
    q = mk(len(lens), hq_, d_)
    kp, vp = (mk(len(lens), n_pages, page, hkv_, d_) for _ in range(2))
    tbl = torch.stack([torch.randperm(n_pages, device=cuda)
                       for _ in lens]).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    out, lse = paged_attention(q, kp, vp, tbl, ln, return_lse=True)
    plain = paged_attention(q, kp, vp, tbl, ln)
    _, ref = paged_attention_ref(q, kp, vp, tbl, ln, return_lse=True)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 2
    assert out.dtype == torch.float32 and torch.equal(out.to(dt), plain)
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1:]).all()
    assert (lse[1:] - ref[1:]).abs().max().item() <= 1e-3


# ---- the decode kernel's work split, modelled in plain torch

def _split_model(q, k, v, lengths, n_split, tpc, softcap=None):
    """What ``csrc/paged_attention.cu`` computes, step for step in fp64:
    row b's valid pages cut into ``n_split`` shares of ceil(n_valid /
    n_split) pages (empty shares at the end), each share walked in copies
    of ``tpc`` tokens with an online softmax, the shares' (m, l, acc) then
    merged as the last CTA of the row merges them. k, v: logical (B, P,
    page, Hkv, D), NULL pages already zero. -> (B, Hq, D)."""
    B_, Hq, D_ = q.shape
    _, P_, page, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.double().reshape(B_, Hkv, G, D_) * D_ ** -0.5
    kf = k.double().reshape(B_, P_ * page, Hkv, D_)
    vf = v.double().reshape(B_, P_ * page, Hkv, D_)
    out = torch.zeros(B_, Hkv, G, D_, dtype=torch.float64)
    for b in range(B_):
        n = min(max(int(lengths[b]), 0), P_ * page)
        n_valid = -(-n // page)
        pps = -(-n_valid // n_split)
        parts = []
        for split in range(n_split):
            t_begin, t_end = split * pps * page, min(n, (split + 1) * pps * page)
            if t_end <= t_begin:
                continue
            m = torch.full((Hkv, G), float("-inf"), dtype=torch.float64)
            l = torch.zeros(Hkv, G, dtype=torch.float64)
            acc = torch.zeros(Hkv, G, D_, dtype=torch.float64)
            for t0 in range(t_begin, t_end, tpc):
                t1 = min(t0 + tpc, t_end)
                s = torch.einsum("hgd,thd->hgt", qg[b], kf[b, t0:t1])
                if softcap is not None:
                    s = softcap * torch.tanh(s / softcap)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "hgt,thd->hgd", p, vf[b, t0:t1])
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue                        # length 0: exact zeros
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - mx) for m, _, _ in parts]
        L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
        A = sum(wi[..., None] * a for wi, (_, _, a) in zip(w, parts))
        out[b] = A / torch.clamp(L, min=1e-20)[..., None]
    return out.reshape(B_, Hq, D_).float()


def _gqa7_inputs(seed=0):
    """G = 7 (qwen2-7b's 28/4 at a small size): Hq 14, Hkv 2, a shared
    page, NULL tails, a length-0 row and an all-NULL row of length 1."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((4, 14, D)).astype(np.float32)
    kp = r.standard_normal((TOTAL, PAGE, HKV, D)).astype(np.float32)
    vp = r.standard_normal((TOTAL, PAGE, HKV, D)).astype(np.float32)
    tbl = np.array([[3, 4, 5, 6], [3, 9, TOTAL, TOTAL], [TOTAL] * 4,
                    [TOTAL] * 4], np.int32)
    lens = np.array([4 * PAGE - 1, PAGE + 2, 0, 1], np.int32)
    return q, kp, vp, tbl, lens


# (n_split, tpc): one share, two, three, more shares than any row has pages
# (empty shares); whole pages and copies of part of a page (tpc < page).
SPLIT_CASES = [(1, PAGE), (2, PAGE), (3, PAGE), (7, PAGE), (1, PAGE // 2),
               (3, PAGE // 4), (7, 1)]


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("n_split,tpc", SPLIT_CASES)
def test_split_model_matches_plain_global(n_split, tpc, softcap):
    q, kp, vp, tbl, lens = map(_t, _paged_inputs(7))
    out = _split_model(q, gather_global_pages(kp, tbl),
                       gather_global_pages(vp, tbl), lens, n_split, tpc,
                       softcap)
    ref = paged_attention_global_ref(q, kp, vp, tbl, lens, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert (out[2] == 0).all() and (out[4] == 0).all()


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("n_split,tpc", SPLIT_CASES)
def test_split_model_matches_plain_slot(n_split, tpc, softcap):
    q, kp, vp, tbl, lens = map(_t, _slot_inputs(7))
    out = _split_model(q, gather_slot_pages(kp, tbl),
                       gather_slot_pages(vp, tbl), lens, n_split, tpc, softcap)
    ref = paged_attention_ref(q, kp, vp, tbl, lens, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert (out[2] == 0).all()


@pytest.mark.parametrize("n_split,tpc,softcap", [(1, PAGE, None),
                                                 (3, PAGE // 4, 30.0),
                                                 (7, PAGE // 2, None)])
def test_split_model_matches_pallas_interpret(n_split, tpc, softcap):
    """Against the Pallas kernels themselves: the global one with "hbm"
    residency (it zeroes NULL pages, as the port reads them), every row,
    and the per-slot one."""
    q, kp, vp, tbl, lens = _paged_inputs(8)
    out = _split_model(*map(_t, (q,)), gather_global_pages(_t(kp), _t(tbl)),
                       gather_global_pages(_t(vp), _t(tbl)), _t(lens),
                       n_split, tpc, softcap)
    pal = np.asarray(pallas_global(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                   softcap=softcap, table_residency="hbm",
                                   interpret=True))
    np.testing.assert_allclose(out.numpy(), pal, atol=ATOL)
    q, kp, vp, tbl, lens = _slot_inputs(8)
    out = _split_model(_t(q), gather_slot_pages(_t(kp), _t(tbl)),
                       gather_slot_pages(_t(vp), _t(tbl)), _t(lens), n_split,
                       tpc, softcap)
    pal = np.asarray(pallas_slot(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                 softcap=softcap, interpret=True))
    np.testing.assert_allclose(out.numpy(), pal, atol=ATOL)


@pytest.mark.parametrize("n_split,tpc", [(1, PAGE), (3, PAGE // 2), (5, 2)])
def test_split_model_gqa7(n_split, tpc):
    """G = 7 against the port's plain version and the Pallas kernel (its
    hbm residency, which zeroes NULL pages as the port does)."""
    q, kp, vp, tbl, lens = _gqa7_inputs(9)
    out = _split_model(_t(q), gather_global_pages(_t(kp), _t(tbl)),
                       gather_global_pages(_t(vp), _t(tbl)), _t(lens),
                       n_split, tpc, 30.0)
    ref = paged_attention_global_ref(*map(_t, (q, kp, vp, tbl, lens)),
                                     softcap=30.0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    pal = np.asarray(pallas_global(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                   softcap=30.0, table_residency="hbm",
                                   interpret=True))
    np.testing.assert_allclose(out.numpy(), pal, atol=ATOL)
    assert (out[2] == 0).all() and (out[3] == 0).all()


@pytest.mark.parametrize("n_valid", [0, 1, 2, 5, 16, 63, 64, 100])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8, 33, 130])
def test_split_shares_cover_each_page_once(n_valid, n_split):
    """The kernel's shares of a row's valid pages: disjoint, in order,
    covering every valid page once; the non-empty ones are a prefix of
    ceil(n_valid / share) splits, the ones the merge reads."""
    pps = -(-n_valid // n_split)
    shares = [range(s * pps, min(n_valid, (s + 1) * pps))
              for s in range(n_split)]
    assert [p for sh in shares for p in sh] == list(range(n_valid))
    used = -(-n_valid // pps) if pps else 0
    assert all(len(sh) > 0 for sh in shares[:used])
    assert all(len(sh) == 0 for sh in shares[used:])


@pytest.mark.parametrize("rows,n_pages,sms", [
    (1, 1, 132), (8, 64, 132), (32, 256, 132), (16, 512, 132),
    (300, 64, 132), (8, 4, 132), (0, 8, 132), (5, 3, 1)])
def test_n_splits_rule(rows, n_pages, sms):
    """At least one split, at most one a page of capacity, and otherwise
    enough CTAs for two an SM."""
    n = n_splits(rows, n_pages, sms)
    assert 1 <= n <= max(n_pages, 1)
    if 1 < n < n_pages:
        assert n == 2 * sms // rows


@pytest.mark.parametrize("page,hkv,g,d,itemsize,tpc,groups", [
    (16, 8, 4, 64, 2, 16, (8, 4, 1)),      # llama3.2-1b: the whole page
    (16, 4, 7, 128, 2, 16, (4, 7, 1)),     # qwen2-7b, G = 7
    (8, 8, 4, 64, 4, 8, (8, 4, 1)),
    (16, 4, 2, 256, 4, 4, (4, 2, 1)),      # fp32 D 256: tpc < page
    (16, 8, 8, 256, 4, 2, (8, 8, 1)),
    (16, 16, 1, 128, 2, 8, (8, 1, 2)),     # olmoe's 16 KV heads: 2 groups
    (16, 12, 2, 64, 2, 16, (6, 2, 2)),
    (8, 1, 16, 64, 2, 8, (1, 8, 2))])      # G 16: 2 query groups
def test_plan_of_a_launch(page, hkv, g, d, itemsize, tpc, groups):
    hg, gq, n_z = head_groups(hkv, g)
    assert (hg, gq, n_z) == groups
    assert tokens_per_copy(page, hg, d, itemsize) == tpc
    assert page % tpc == 0 and 2 * tpc * hg * d * itemsize <= 32 * 1024
    assert paged_ops.plan(4, hkv, g, d, itemsize, page, 10, 132)[:4] == \
        (hg, gq, n_z, tpc)


@pytest.mark.parametrize("dtype,d,offset,ok", [
    (torch.float32, 32, 0, True), (torch.bfloat16, 64, 0, True),
    (torch.float32, 6, 0, False), (torch.bfloat16, 12, 0, False),
    (torch.float32, 512, 0, False), (torch.bfloat16, 512, 0, False),
    (torch.float32, 32, 2, False),
    (torch.bfloat16, 64, 8, True), (torch.bfloat16, 64, 4, False)])
def test_bulk_copy_input_rules(dtype, d, offset, ok):
    """What the kernel's bulk copies refuse, checked before any launch: a
    row of D * itemsize not a multiple of 16 bytes, a pool base off 16
    bytes; and D over 256."""
    flat = torch.zeros(offset + 2 * 8 * 2 * d, dtype=dtype)
    pool = flat[offset:].view(2, 8, 2, d)
    if ok:
        paged_ops._check_bulk(pool, pool)
    else:
        with pytest.raises(ValueError):
            paged_ops._check_bulk(pool, pool)


@pytest.mark.parametrize("past_capacity", [False, True])
def test_slot_decode_attention_matches_jax_model(past_capacity):
    """The per-slot model function: JAX attends in physical order through
    the inverse table, the port through the table in logical order. Past
    capacity (a sliding-window ring that has wrapped) every slot is
    valid."""
    q, kp, vp, tbl, lens = _slot_inputs(4)
    if past_capacity:
        lens = lens + 2 * P * PAGE + 3
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(lens))
    tkv = tattn.PagedKV(_t(kp), _t(vp), _t(tbl), _t(lens))
    assert not tattn.is_global_layout(tkv) and tkv.capacity == P * PAGE
    for cap in (None, 30.0, 50.0):
        ref = np.asarray(jattn.paged_decode_attention(
            jnp.asarray(q)[:, None], jkv, softcap=cap))
        out = tattn.paged_decode_attention(_t(q)[:, None], tkv,
                                           softcap=cap).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL)


def test_slot_gather_and_append_match_jax_model():
    """Per-slot append, exact pools and lengths; a row at capacity wraps to
    position 0 and the length-0 row writes its page ``tbl[b, 0]``."""
    q, kp, vp, tbl, lens = _slot_inputs(5)
    lens = np.array([21, 19, 0, 4 * PAGE, 1], np.int32)
    r = np.random.default_rng(5)
    kn = r.standard_normal((B, 1, HKV, D)).astype(np.float32)
    vn = r.standard_normal((B, 1, HKV, D)).astype(np.float32)
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(lens))
    tkv = tattn.PagedKV(_t(kp.copy()), _t(vp.copy()), _t(tbl), _t(lens))
    np.testing.assert_array_equal(
        tattn.gather_pages(tkv.k_pool, tkv.block_table).numpy(),
        np.asarray(jattn.gather_pages(jkv.k_pool, jkv.block_table)))
    jn = jattn.paged_append(jkv, jnp.asarray(kn), jnp.asarray(vn))
    tn = tattn.paged_append(tkv, _t(kn), _t(vn))
    assert tn.k_pool is tkv.k_pool              # written in place
    np.testing.assert_array_equal(tn.k_pool.numpy(), np.asarray(jn.k_pool))
    np.testing.assert_array_equal(tn.v_pool.numpy(), np.asarray(jn.v_pool))
    np.testing.assert_array_equal(tn.length.numpy(), np.asarray(jn.length))


def test_paged_decode_attention_matches_jax_model():
    q, kp, vp, tbl, lens = _paged_inputs(2)
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(lens))
    tkv = tattn.PagedKV(_t(kp), _t(vp), _t(tbl), _t(lens))
    ref = np.asarray(jattn.paged_decode_attention(jnp.asarray(q)[:, None], jkv))
    out = tattn.paged_decode_attention(_t(q)[:, None], tkv).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_gather_and_append_match_jax_model():
    q, kp, vp, tbl, lens = _paged_inputs(3)
    lens = np.array([21, 19, 0, 31, 1], np.int32)
    r = np.random.default_rng(3)
    kn = r.standard_normal((B, 1, HKV, D)).astype(np.float32)
    vn = r.standard_normal((B, 1, HKV, D)).astype(np.float32)
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(lens))
    tkv = tattn.PagedKV(_t(kp.copy()), _t(vp.copy()), _t(tbl), _t(lens))
    for a, b in zip(tattn.gather_global_pages(tkv),
                    jattn.gather_global_pages(jkv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jn = jattn.paged_append(jkv, jnp.asarray(kn), jnp.asarray(vn))
    tn = tattn.paged_append(tkv, _t(kn), _t(vn))   # row 2: NULL, dropped
    np.testing.assert_array_equal(tn.k_pool.numpy(), np.asarray(jn.k_pool))
    np.testing.assert_array_equal(tn.v_pool.numpy(), np.asarray(jn.v_pool))
    np.testing.assert_array_equal(tn.length.numpy(), np.asarray(jn.length))


def test_prefix_context_attention_matches_jax_model():
    r = np.random.default_rng(4)
    _, kp, vp, tbl, _ = _paged_inputs(4)
    S = 6
    q = r.standard_normal((B, S, HQ, D)).astype(np.float32)
    ks = r.standard_normal((B, S, HKV, D)).astype(np.float32)
    vs = r.standard_normal((B, S, HKV, D)).astype(np.float32)
    pre = np.array([8, 16, 0, 24, 0], np.int32)
    suf = np.array([6, 3, 4, 6, 0], np.int32)
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(pre))
    tkv = tattn.PagedKV(_t(kp), _t(vp), _t(tbl), _t(pre))
    ref = jattn.prefix_context_attention(
        *map(jnp.asarray, (q, ks, vs)), jkv, jnp.asarray(pre),
        jnp.asarray(suf), softcap=20.0)
    out = tattn.prefix_context_attention(_t(q), _t(ks), _t(vs), tkv, _t(pre),
                                         _t(suf), softcap=20.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, q_offset, chunks
    (2, 16, 16, 4, 2, 16, True, None, None, 0, (8, 4)),
    (2, 16, 16, 4, 4, 16, False, None, None, 0, (16, 16)),
    (1, 24, 24, 6, 2, 8, True, None, 25.0, 0, (8, 12)),
    (2, 20, 20, 4, 1, 16, True, 5, None, 0, (10, 4)),
    (1, 12, 20, 4, 2, 16, True, 7, 15.0, 8, (4, 6)),
    (2, 8, 32, 2, 2, 16, False, None, None, 24, (16, 8)),
]


# The wgmma kernel's head dims (64, 128, 256): GQA, sizes that are no
# multiple of its 64-row tiles, window, softcap 50.0 and q_offset (the last
# case's reaches past Skv - Sq).
FLASH_WIDE_CASES = [
    (1, 70, 70, 4, 2, 64, True, None, None, 0, (35, 14)),
    (2, 65, 65, 4, 4, 128, False, None, None, 0, (13, 65)),
    (1, 100, 100, 4, 1, 128, True, 48, 50.0, 0, (50, 20)),
    (1, 48, 80, 8, 2, 256, True, 16, None, 40, (40, 16)),
    (1, 37, 101, 2, 1, 256, True, None, 50.0, 70, (101, 37)),
]


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_WIDE_CASES)
def test_flash_plain_matches_jax_model(case):
    B_, Sq, Skv, Hq, Hkv, D_, causal, window, cap, qoff, (kvc, qc) = case
    r = np.random.default_rng(Sq + Skv)
    q = r.standard_normal((B_, Sq, Hq, D_)).astype(np.float32)
    k = r.standard_normal((B_, Skv, Hkv, D_)).astype(np.float32)
    v = r.standard_normal((B_, Skv, Hkv, D_)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), kv_chunk=kvc,
                                q_chunk=qc, **kw)
    out = flash_attention_fwd(_t(q), _t(k), _t(v), kv_chunk=kvc, q_chunk=qc,
                              **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal,softcap,gqa", [(True, None, 2),
                                                (False, None, 1),
                                                (True, 30.0, 4)])
def test_flash_plain_matches_dense_oracle(causal, softcap, gqa):
    r = np.random.default_rng(9)
    B_, S, Hkv, D_ = 2, 24, 2, 16
    q = r.standard_normal((B_, S, Hkv * gqa, D_)).astype(np.float32)
    k = r.standard_normal((B_, S, Hkv, D_)).astype(np.float32)
    v = r.standard_normal((B_, S, Hkv, D_)).astype(np.float32)
    kr, vr = np.repeat(k, gqa, axis=2), np.repeat(v, gqa, axis=2)
    ref = attention_ref(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, kr, vr)),
                        causal=causal, softcap=softcap).swapaxes(1, 2)
    out = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                              softcap=softcap, kv_chunk=8, q_chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_wrappers_reject_bad_inputs():
    sq, skp, svp, stbl, slens = map(_t, _slot_inputs())
    with pytest.raises(ValueError):
        paged_attention(sq, skp[:3], svp[:3], stbl, slens)
    with pytest.raises(ValueError):
        paged_attention(sq, skp, svp, stbl[:, :2].contiguous(), slens)
    with pytest.raises(ValueError):
        paged_attention(sq, skp, svp, stbl, slens, table_residency="vmem")
    with pytest.raises(TypeError):
        paged_attention(sq.double(), skp, svp, stbl, slens)
    q, kp, vp, tbl, lens = map(_t, _paged_inputs())
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, tbl, lens)          # a global pool
    with pytest.raises(ValueError):
        paged_attention_global(q, kp, vp, tbl, lens, table_residency="vmem")
    with pytest.raises(TypeError):
        paged_attention_global(q.double(), kp, vp, tbl, lens)
    with pytest.raises(TypeError):
        paged_attention_global(q, kp, vp, tbl.long(), lens)
    with pytest.raises(ValueError):
        paged_attention_global(q, kp, vp, tbl[:2], lens)
    with pytest.raises(ValueError):
        paged_attention_global(q, kp.transpose(1, 2), vp.transpose(1, 2),
                               tbl, lens)
    x = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention_fwd(x, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attention_fwd(x.transpose(1, 2), x.transpose(1, 2),
                            x.transpose(1, 2))
    with pytest.raises(TypeError):
        flash_attention_fwd(x.half(), x.half(), x.half())
    # fp32 at head dim 128: no kernel takes it. The plain version would;
    # off the CPU the wrapper refuses before it looks for a card.
    y = torch.zeros(1, 8, 4, 128, device="meta")
    with pytest.raises(ValueError, match="head dim 128"):
        flash_attention_fwd(y, y, y)


@pytest.mark.parametrize("dtype,head_dim,kind", [
    ("float32", 16, "simt"), ("float32", 32, "simt"), ("float32", 64, "simt"),
    ("bfloat16", 16, "simt"), ("bfloat16", 32, "simt"),
    ("bfloat16", 64, "wgmma"), ("bfloat16", 112, "wgmma"),
    ("bfloat16", 128, "wgmma"), ("bfloat16", 256, "wgmma")])
def test_flash_kernel_for(dtype, head_dim, kind):
    assert kernel_for(getattr(torch, dtype), head_dim) == kind


@pytest.mark.parametrize("dtype,head_dim,exc", [
    ("bfloat16", 48, ValueError), ("float32", 112, ValueError),
    ("float32", 128, ValueError),
    ("float32", 256, ValueError), ("bfloat16", 8, ValueError),
    ("float16", 64, TypeError), ("float16", 128, TypeError)])
def test_flash_kernel_for_rejects(dtype, head_dim, exc):
    with pytest.raises(exc):
        kernel_for(getattr(torch, dtype), head_dim)


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """An edited or added ``csrc/*.cuh`` renames every library, so a stale
    build is never loaded; the same files give the same path."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert {n: build.library_path(n) for n in build.SOURCES} == before
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: build.library_path(n) for n in build.SOURCES}
    assert all(edited[n] != before[n] for n in build.SOURCES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("flash_attention") != edited["flash_attention"]


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    q, kp, vp, tbl, lens = map(_t, _paged_inputs())
    paged_attention_global(q, kp, vp, tbl, lens)
    paged_attention_global(q, kp, vp, tbl, lens, table_residency="hbm")
    paged_attention(*map(_t, _slot_inputs()))
    x = torch.zeros(1, 8, 4, 16)
    flash_attention_fwd(x, x, x)
    assert launch_counts() == {"paged_attention_global": 0,
                               "paged_attention": 0,
                               "flash_attention_fwd": 0, "gemm": 0,
                               "gesummv": 0, "axpy": 0, "heat3d_step": 0,
                               "block_sort": 0, "merge_stage": 0,
                               "merge_tile": 0}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_paged_kernel_matches_plain_on_card(cuda, dtype, tol):
    dt = getattr(torch, dtype)
    q, kp, vp, tbl, lens = (_t(a).to(cuda) for a in _paged_inputs(5))
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    before = paged_attention_global.launches
    out = paged_attention_global(q, kp, vp, tbl, lens, softcap=30.0)
    ref = paged_attention_global_ref(q, kp, vp, tbl, lens, softcap=30.0)
    torch.cuda.synchronize()
    assert paged_attention_global.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("residency", ["smem", "hbm"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_slot_kernel_matches_plain_on_card(cuda, dtype, tol, residency):
    dt = getattr(torch, dtype)
    q, kp, vp, tbl, lens = (_t(a).to(cuda) for a in _slot_inputs(6))
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, tbl, lens, softcap=30.0,
                          table_residency=residency)
    ref = paged_attention_ref(q, kp, vp, tbl, lens, softcap=30.0)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert (out[2] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _card_decode_inputs(per_slot, dt, D_, page, Hq_, Hkv_, device, seed=0):
    """Rows of length 0, 1, page - 1, page, page + 1 and the full table,
    NULL entries past each length, and an all-NULL row of length 1; in the
    global layout the full row shares its first page with the page-long
    row."""
    P_ = 5
    lens = [0, 1, page - 1, page, page + 1, P_ * page, 1]
    B_ = len(lens)
    rng = np.random.default_rng(seed)
    if per_slot:
        tbl = np.stack([rng.permutation(P_) for _ in range(B_)]).astype(np.int32)
        for b, n in enumerate(lens[:-1]):
            tbl[b, -(-n // page):] = P_
        tbl[-1] = P_
        shape = (B_, P_, page, Hkv_, D_)
    else:
        total = B_ * P_
        perm = rng.permutation(total)
        tbl = np.full((B_, P_), total, np.int32)
        nxt = 0
        for b, n in enumerate(lens[:-1]):
            k = -(-n // page)
            tbl[b, :k] = perm[nxt:nxt + k]
            nxt += k
        tbl[5, 0] = tbl[3, 0]
        shape = (total, page, Hkv_, D_)
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=device).to(dt)
    return (mk(B_, Hq_, D_), mk(*shape), mk(*shape),
            torch.from_numpy(tbl).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


def _decode_on_card(per_slot, q, kp, vp, tbl, lens, softcap):
    """One call of the layout's wrapper against its plain version; asserts
    exactly one launch and exact zeros in the length-0 and all-NULL rows.
    Returns the max abs error."""
    fn, ref_fn = ((paged_attention, paged_attention_ref) if per_slot
                  else (paged_attention_global, paged_attention_global_ref))
    before = fn.launches
    out = fn(q, kp, vp, tbl, lens, softcap=softcap)
    ref = ref_fn(q, kp, vp, tbl, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all() and (out[-1] == 0).all()
    return (out.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("hq_,hkv_", [(4, 2), (32, 8), (28, 4), (8, 4)])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("d_", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_kernel_grid_on_card(cuda, per_slot, dtype, tol, d_, page,
                                    hq_, hkv_, softcap):
    dt = getattr(torch, dtype)
    args = _card_decode_inputs(per_slot, dt, d_, page, hq_, hkv_, cuda,
                               seed=d_ + page + hq_)
    if dt == torch.float32 and d_ == 256 and hkv_ == 4 and page == 16:
        hg = head_groups(hkv_, hq_ // hkv_)[0]
        assert tokens_per_copy(page, hg, d_, 4) < page   # copies of part a page
    assert _decode_on_card(per_slot, *args, softcap) <= tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_decode_ring_past_capacity_on_card(cuda, dtype, tol):
    """gemma2's sliding-window decode: per-slot rings (full permutation
    tables) whose lengths reach and pass their capacity, D 256, G 2 (8/4
    heads), softcap 50. Every slot of a wrapped ring is valid."""
    dt = getattr(torch, dtype)
    n_pages, page = 5, 16
    cap = n_pages * page
    lens = [cap, cap + 1, cap + page + 3, 3 * cap + 5]
    rng = np.random.default_rng(7)
    tbl = np.stack([rng.permutation(n_pages) for _ in lens]).astype(np.int32)
    g = torch.Generator(device=cuda).manual_seed(7)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=cuda).to(dt)
    shape = (len(lens), n_pages, page, 4, 256)
    q, kp, vp = mk(len(lens), 8, 256), mk(*shape), mk(*shape)
    tbl = torch.from_numpy(tbl).to(cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, tbl, lens, softcap=50.0)
    ref = paged_attention_ref(q, kp, vp, tbl, lens, softcap=50.0)
    full = paged_attention_ref(q, kp, vp, tbl, torch.full_like(lens, cap),
                               softcap=50.0)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert torch.equal(ref, full)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("sms", [1, 132, 10000])
@pytest.mark.parametrize("hq_,hkv_,d_", [(32, 8, 64), (16, 16, 128),
                                         (64, 4, 64), (24, 12, 32),
                                         (64, 8, 112), (8, 2, 48)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_kernel_splits_on_card(cuda, monkeypatch, per_slot, hq_, hkv_,
                                      d_, sms):
    """One split (the CTA writes the output), the card's count, and one
    split a page (the fused merge over every share); more than 8 KV heads
    (head groups), G = 16 (query groups), and bf16 head dims off the
    tensor-core path (112, 48: the CUDA-core one)."""
    monkeypatch.setattr(paged_ops, "_sm_count", lambda device: sms)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        args = _card_decode_inputs(per_slot, getattr(torch, dtype), d_, 16,
                                   hq_, hkv_, cuda, seed=sms + hq_)
        assert _decode_on_card(per_slot, *args, 30.0) <= tol


def test_decode_kernel_rejects_misaligned_pool_on_card(cuda):
    q, kp, vp, tbl, lens = _card_decode_inputs(False, torch.float32, 64, 16,
                                               8, 4, cuda)
    flat = torch.zeros(kp.numel() + 2, device=cuda)
    k_off = flat[2:].view(kp.shape)                 # 8 bytes off 16
    k_off.copy_(kp)
    before = paged_attention_global.launches
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention_global(q, k_off, vp, tbl, lens)
    assert paged_attention_global.launches == before


def _half_ulp_bf16(x):
    """Half the spacing of bf16 values at |x|: a bf16 output's own
    rounding."""
    a = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 8)


def _plain_fp32(per_slot, q, kp, vp, tbl, lens, softcap=None):
    """The layout's plain version on fp32 copies of the inputs: the fp32 P
    of the reference, with no rounding of the output."""
    ref_fn = paged_attention_ref if per_slot else paged_attention_global_ref
    return ref_fn(q.float(), kp.float(), vp.float(), tbl, lens,
                  softcap=softcap)


@pytest.mark.parametrize("per_slot", [False, True])
def test_p_cancellation_case_bites(per_slot):
    """On the cancellation case a decode that rounds P to bf16 misses the
    fp32 plain version by more than 16 times the output's own rounding,
    while the plain bf16 version (the CPU path) stays within that rounding;
    the fp32 plain version equals the JAX oracle."""
    args = p_cancellation_case(per_slot, "cpu")
    ref32 = _plain_fp32(per_slot, *args)
    half_ulp = _half_ulp_bf16(ref32).max().item()
    err_rounded = (decode_p_rounded(*args) - ref32).abs().max().item()
    assert err_rounded > 16 * half_ulp
    fn = paged_attention if per_slot else paged_attention_global
    assert ((fn(*args).float() - ref32).abs() <= _half_ulp_bf16(ref32)
            + 1e-6).all()
    q, kp, vp, tbl, lens = (a.float().numpy() if a.is_floating_point()
                            else a.numpy() for a in args)
    oracle = (jax_slot_ref if per_slot else jax_global_ref)(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens))
    np.testing.assert_allclose(ref32.numpy(), np.asarray(oracle), atol=1e-5)


def test_cancellation_scores_round_apart():
    """The two scores' P fall between bf16 neighbours on opposite sides:
    one rounds down and one up, each by more than 0.3 of a spacing."""
    for d_ in (16, 64, 128):
        lo, hi = (torch.tensor(k / d_ ** 0.5, dtype=torch.float64).exp()
                  for k in cancellation_scores(d_))
        assert lo.bfloat16().double() < lo - 0.3 / 256
        assert hi.bfloat16().double() > hi + 0.3 / 256


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_bf16_keeps_p_precision_on_card(cuda, per_slot):
    """The bf16 tensor-core path carries P through P.V at about 16 bits:
    on the cancellation case its error is within 1/16 of a decode that
    rounds P to bf16, which itself misses by more than 16 times the
    output's rounding."""
    args = p_cancellation_case(per_slot, cuda)
    fn = paged_attention if per_slot else paged_attention_global
    before = fn.launches
    out = fn(*args)
    ref32 = _plain_fp32(per_slot, *args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    err_rounded = (decode_p_rounded(*args) - ref32).abs().max().item()
    err_kernel = (out.float() - ref32).abs().max().item()
    print(f"per_slot={per_slot} kernel {err_kernel} p_rounded {err_rounded}")
    assert err_rounded > 16 * _half_ulp_bf16(ref32).max().item()
    assert err_kernel <= err_rounded / 16


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_bf16_within_1e3_on_card(cuda, per_slot):
    """bf16 decode on every shape of the card grid is within 1e-3 of the
    fp32 plain version, beyond the output's own bf16 rounding (half a
    spacing at the output: a bf16 output whose exact value lies near a
    rounding midpoint can land one spacing from the plain bf16 output)."""
    worst, worst_bf16 = 0.0, 0.0
    for d_, page, (hq_, hkv_), softcap in itertools.product(
            (16, 64, 128, 256), (8, 16), ((4, 2), (32, 8), (28, 4), (8, 4)),
            (None, 30.0)):
        args = _card_decode_inputs(per_slot, torch.bfloat16, d_, page, hq_,
                                   hkv_, cuda, seed=d_ + page + hq_)
        worst_bf16 = max(worst_bf16, _decode_on_card(per_slot, *args,
                                                     softcap))
        fn = paged_attention if per_slot else paged_attention_global
        out = fn(*args, softcap=softcap).float()
        ref32 = _plain_fp32(per_slot, *args, softcap=softcap)
        excess = (out - ref32).abs() - _half_ulp_bf16(out)
        worst = max(worst, excess.max().item())
    print(f"per_slot={per_slot} beyond rounding {worst} "
          f"against the plain bf16 output {worst_bf16}")
    assert worst <= 1e-3


# bf16 cases of the wgmma kernel on the card: ragged Sq/Skv, non-causal,
# window, softcap, q_offset past Skv - Sq, and rows that see no key (the
# fifth case's rows 27..69: a window of 8 back from q_pos >= 127 finds no
# key of 0..119), which must come out 0. Then fewer query rows than one
# consumer warpgroup's 64 (the TMA box of 128 rows reads zeros past Sq):
# cross-attention's decode (Sq = 1, non-causal, GQA) over sources shorter
# and longer than a KV tile, a few rows causal with an offset, and a
# source of 9 keys. Last, head dim 112 (kimi-k2's: two 64-column slabs, the
# second zero-padded past column 112): causal at G = 8, non-causal, Sq = 1,
# a window, and a q_offset with a softcap.
FLASH_CARD_BF16 = [
    (2, 100, 100, 8, 2, 64, True, None, 50.0, 0),
    (1, 130, 130, 4, 4, 128, False, None, None, 0),
    (2, 77, 141, 4, 2, 256, True, 48, 50.0, 64),
    (1, 65, 200, 4, 1, 128, True, None, None, 150),
    (1, 70, 120, 2, 1, 64, True, 8, None, 100),
    (2, 129, 129, 2, 2, 256, False, 32, None, 0),
    (1, 200, 260, 8, 2, 64, True, 100, None, 60),
    (3, 1, 200, 8, 2, 64, False, None, None, 0),
    (2, 1, 77, 8, 1, 128, False, None, None, 0),
    (2, 1, 16, 4, 4, 64, False, None, None, 0),
    (2, 5, 100, 4, 2, 256, False, None, None, 0),
    (1, 33, 70, 4, 2, 64, True, None, None, 37),
    (1, 17, 9, 4, 4, 128, False, None, None, 0),
    (2, 100, 100, 16, 2, 112, True, None, None, 0),
    (1, 130, 130, 4, 4, 112, False, None, None, 0),
    (2, 1, 77, 8, 1, 112, False, None, None, 0),
    (1, 200, 260, 8, 1, 112, True, 100, None, 60),
    (1, 65, 200, 8, 2, 112, True, None, 50.0, 150),
]


@pytest.mark.parametrize("dtype,case", [("float32", c) for c in FLASH_CASES]
                         + [("bfloat16", c) for c in FLASH_CARD_BF16])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, case):
    torch.backends.cuda.matmul.allow_tf32 = False
    B_, Sq, Skv, Hq, Hkv, D_, causal, window, cap, qoff = case[:10]
    dt = getattr(torch, dtype)
    if dt == torch.float32 and D_ not in (16, 32, 64):
        pytest.skip(f"kernel head dims are 16/32/64, not {D_}")
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B_, Sq, Hq, D_, generator=g, device=cuda).to(dt)
    k = torch.randn(B_, Skv, Hkv, D_, generator=g, device=cuda).to(dt)
    v = torch.randn(B_, Skv, Hkv, D_, generator=g, device=cuda).to(dt)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    wgmma = flash_attention_fwd.wgmma_launches
    out = flash_attention_fwd(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert flash_attention_fwd.wgmma_launches == wgmma + (
        kernel_for(dt, D_) == "wgmma")
    qp = torch.arange(Sq, device=cuda)[:, None] + qoff
    kp = torch.arange(Skv, device=cuda)[None, :]
    sees = torch.ones(Sq, Skv, dtype=torch.bool, device=cuda)
    if causal:
        sees &= kp <= qp
    if window is not None:
        sees &= qp - kp < window
    blind = ~sees.any(dim=1)
    assert (out[:, blind] == 0).all()
    if case == FLASH_CARD_BF16[4]:
        assert 0 < blind.sum().item() < Sq


@pytest.mark.parametrize("dtype,case", [("float32", c) for c in FLASH_CASES]
                         + [("bfloat16", c) for c in FLASH_CARD_BF16])
def test_flash_kernel_lse_matches_plain_on_card(cuda, dtype, case):
    """The kernels' log-sum-exp (the training path's residual) against the
    plain version's within 1e-3 (fp32 sums in another order), rows that see
    no key at log(1e-20); ``out`` bit for bit with and without it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B_, Sq, Skv, Hq, Hkv, D_, causal, window, cap, qoff = case[:10]
    dt = getattr(torch, dtype)
    if dt == torch.float32 and D_ not in (16, 32, 64):
        pytest.skip(f"kernel head dims are 16/32/64, not {D_}")
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B_, Sq, Hq, D_, generator=g, device=cuda).to(dt)
    k = torch.randn(B_, Skv, Hkv, D_, generator=g, device=cuda).to(dt)
    v = torch.randn(B_, Skv, Hkv, D_, generator=g, device=cuda).to(dt)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    out, lse = flash_attention_fwd(q, k, v, **kw, return_lse=True)
    _, ref_lse = flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (B_, Sq, Hq) and lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(out, flash_attention_fwd(q, k, v, **kw))
    if case == FLASH_CARD_BF16[4]:
        assert (ref_lse == float(np.float32(np.log(1e-20)))).any()
