"""The LM kernels' autograd on the card, run on the CPU with the plain
forward standing in for the kernel (``launch=``): the wrappers' card path
(``flash_attention_on_card``, ``rmsnorm_on_card``) and their
``autograd.Function``s, whose backward is the plain version's gradient.
In float64 the gradients equal autograd of the plain version (1e-6
relative: the plain versions compute in float32, and the padded head dim
sums its zeros in another order), and the plain version's equal those of
an attention written out in float64 within 1e-5. The backward launches
nothing; without autograd (no input requiring grad, ``no_grad``,
``inference_mode``) the launch is called as it was, once, with no graph.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_on_card
from repro_torch.kernels.rmsnorm import rmsnorm_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm_on_card

REL = 1e-6


class Counted:
    """A stand-in launch (the plain forward) that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def _flash_plain(q, k, v, *, causal, scale):
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)


def _attention_f64(q, k, v, causal, scale):
    h, kvh, sq, sk = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    k, v = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        mask = torch.arange(sk)[None, :] > torch.arange(sq)[:, None] + (sk - sq)
        s = s.masked_fill(mask, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def _close(got, want, rel, what):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max|d|={err:.3e} > {rel} x max|ref|={scale:.3e}"


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,scale", [
    (2, 4, 4, 9, 9, 16, True, None),
    (1, 4, 4, 5, 12, 16, True, None),      # causal offset sk - sq on the true lengths
    (2, 6, 6, 7, 11, 16, False, None),
    (2, 8, 2, 10, 10, 32, True, 0.3),      # GQA: a kv head's gradient sums its group
    (1, 4, 1, 6, 6, 24, True, None),       # head dim 24 runs padded to the 32 instance
], ids=["causal", "offset", "non-causal", "gqa-scale", "pad-24"])
def test_flash_backward_is_the_plain_gradient(b, h, kvh, sq, sk, d, causal, scale):
    gen = torch.Generator().manual_seed(sq * d)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
               for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d)))
    do = torch.randn((b, h, sq, d), generator=gen, dtype=torch.float64)
    scale = d ** -0.5 if scale is None else scale
    launch = Counted(_flash_plain)
    o = flash_attention_on_card(q, k, v, causal=causal, scale=scale, launch=launch)
    assert launch.calls == 1 and o.shape == (b, h, sq, d) and o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    assert launch.calls == 1  # the backward launched nothing
    o_ref = flash_attention_ref(q, k, v, causal=causal, scale=scale)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    o64 = _attention_f64(q, k, v, causal, scale)
    exact = torch.autograd.grad(o64, (q, k, v), do)
    _close(o, o_ref, REL, "o")
    for name, g, w, e in zip("qkv", got, want, exact):
        assert g.dtype == torch.float64 and g.shape == w.shape
        _close(g, w, REL, f"d{name} vs the plain version")
        _close(w, e, 1e-5, f"d{name} of the plain version vs float64")


def test_flash_backward_takes_only_the_inputs_that_require_grad():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 2, 5, 16), generator=gen, dtype=torch.float64, requires_grad=True)
    k, v = (torch.randn((1, 2, 5, 16), generator=gen, dtype=torch.float64) for _ in range(2))
    o = flash_attention_on_card(q, k, v, causal=True, scale=0.25, launch=_flash_plain)
    (dq,) = torch.autograd.grad(o.sum(), (q,))
    (want,) = torch.autograd.grad(flash_attention_ref(q, k, v, causal=True, scale=0.25).sum(), (q,))
    _close(dq, want, REL, "dq")


@pytest.mark.parametrize("context", ["no-input-grad", "no_grad", "inference_mode"])
def test_flash_and_rmsnorm_without_autograd_launch_as_before(context):
    gen = torch.Generator().manual_seed(2)
    grad = context != "no-input-grad"
    q, k, v = (torch.randn((1, 2, 4, 16), generator=gen, requires_grad=grad) for _ in range(3))
    x = torch.randn((3, 8), generator=gen, requires_grad=grad)
    w = torch.randn(8, generator=gen, requires_grad=grad)
    flash, norm = Counted(_flash_plain), Counted(lambda x, w, eps: rmsnorm_ref(x, w, eps))
    ctx = {"no-input-grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[context]
    with ctx():
        o = flash_attention_on_card(q, k, v, causal=True, scale=0.25, launch=flash)
        y = rmsnorm_on_card(x, w, 1e-6, launch=norm)
    assert flash.calls == norm.calls == 1
    assert o.grad_fn is None and y.grad_fn is None


@pytest.mark.parametrize("xdtype,wdtype", [(torch.float64, torch.float64), (torch.bfloat16, torch.float32),
                                           (torch.float32, torch.float32)])
def test_rmsnorm_backward_is_the_plain_gradient(xdtype, wdtype):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((2, 5, 24), generator=gen, dtype=torch.float64) * 3).to(xdtype).requires_grad_()
    w = (1 + 0.1 * torch.randn(24, generator=gen, dtype=torch.float64)).to(wdtype).requires_grad_()
    dy = torch.randn((2, 5, 24), generator=gen, dtype=torch.float64).to(xdtype)
    launch = Counted(lambda x, w, eps: rmsnorm_ref(x, w, eps))
    y = rmsnorm_on_card(x, w, 1e-6, launch=launch)
    assert launch.calls == 1 and y.dtype == xdtype
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert launch.calls == 1
    want_dx, want_dw = torch.autograd.grad(rmsnorm_ref(x, w, 1e-6), (x, w), dy)
    assert dx.dtype == xdtype and dw.dtype == wdtype
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    torch.testing.assert_close(dw, want_dw, rtol=0, atol=0)
    if xdtype == torch.float64:  # the closed form, f32 statistics aside
        x64, w64 = x.detach(), w.detach()
        r = torch.rsqrt(x64.square().mean(-1, keepdim=True) + 1e-6)
        g = dy * w64
        exact_dx = r * g - x64 * r ** 3 * (g * x64).mean(-1, keepdim=True)
        exact_dw = (dy * x64 * r).sum((0, 1))
        _close(dx, exact_dx, 1e-5, "dx vs the closed form")
        _close(dw, exact_dw, 1e-5, "dw vs the closed form")
