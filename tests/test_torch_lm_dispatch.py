"""Which LM loop a bundle adjustment takes, on the CPU and without a card
(`geometry/bundle.takes_kernel`, `ops/cuda_lm`).

- The kernel's cap: n = K·N parameters up to `cuda_lm.MAX_PARAMS` (128)
  on a CUDA device go to the kernel, one camera more to the plain loop;
  CPU tensors never; decided from the device and the shape alone.
- CPU tensors take the plain loop: the library is never built, nothing
  counts `lm_fused`, and `lm_iters` counts the plain loop's steps.
- The kernel path's plumbing (with the launch replaced by a stand-in):
  the arguments it hands the kernel, the counters `lm_fused` and
  `lm_iters`, the stage `lm_step`, and the re-anchoring after it.
- The wrapper refuses what the kernel does not take before it builds.

The kernel itself runs only on a card: `tests/test_torch_cuda.py`.
"""

import pytest

torch = pytest.importorskip("torch")

from imagestitch_tpu_torch.geometry import bundle  # noqa: E402
from imagestitch_tpu_torch.ops import cuda_build, cuda_lm  # noqa: E402
from imagestitch_tpu_torch.testing import bundle_problem  # noqa: E402
from imagestitch_tpu_torch.utils import log  # noqa: E402

torch.set_num_threads(2)

CHAIN = [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)]


@pytest.mark.parametrize("kind,n_cams,kernel", [
    ("ray", 2, True), ("ray", 32, True), ("ray", 33, False),
    ("reproj", 18, True), ("reproj", 19, False)])
def test_the_cap_on_shapes_alone(kind, n_cams, kernel):
    n = cuda_lm.PARAMS_PER_CAMERA[kind] * n_cams
    assert bundle.takes_kernel(torch.device("cuda"), n) is kernel
    assert bundle.takes_kernel(torch.device("cuda", 1), n) is kernel
    assert bundle.takes_kernel(torch.device("cpu"), n) is False


def test_the_cap_is_128_parameters():
    assert cuda_lm.fits(128) and not cuda_lm.fits(132)
    assert bundle.takes_kernel(torch.device("cuda"), 128)
    assert not bundle.takes_kernel(torch.device("cuda"), 132)


def _no_build(monkeypatch):
    def boom(*_):
        raise AssertionError("kernel library requested")

    monkeypatch.setattr(cuda_build, "load_library", boom)


@pytest.mark.parametrize("kind", ["ray", "reproj"])
def test_cpu_tensors_take_the_plain_loop(monkeypatch, kind):
    """No build, no `lm_fused`; `lm_iters` counts the plain loop's steps
    (one residual call before the loop, three per step)."""
    _no_build(monkeypatch)
    calls = []
    plain = bundle._lm_minimize

    def spy(residuals, x0, iters):
        n = [0]

        def counted(x):
            n[0] += 1
            return residuals(x)

        out = plain(counted, x0, iters)
        calls.append(n[0])
        return out

    monkeypatch.setattr(bundle, "_lm_minimize", spy)
    n0 = cuda_lm.launch_count
    timer = log.StageTimer(sync=False)
    with timer.active():
        bundle.bundle_adjust(*bundle_problem(4, CHAIN, 64, seed=2), 6, kind)
    counts = timer.counts()
    assert "lm_fused" not in counts
    assert len(calls) == 1 and counts["lm_iters"] == (calls[0] - 1) // 3
    assert 1 <= counts["lm_iters"] <= 6
    assert cuda_lm.launch_count == n0


@pytest.mark.parametrize("kind", ["ray", "reproj"])
def test_kernel_path_plumbing(monkeypatch, kind):
    """With the dispatch forced and the launch replaced by a stand-in that
    returns x0 and 3 iterations: the kernel gets the adjuster's x0, points,
    masks and pair indices (the ray residual its principal points), the
    entry counts `lm_fused` 1 and `lm_iters` 3 in one `lm_step` stage, and
    the cameras come back re-anchored as the plain path does."""
    problem = bundle_problem(3, [(0, 1), (1, 2), (0, 2)], 32, seed=5,
                             masked=0.25)
    cams, src, dst, ptv, pf, pt, pv = problem
    seen = {}

    def stand_in(kind_, x0, src_, dst_, ptv_, pv_, pf_, pt_, ppx, ppy,
                 iters):
        seen.update(kind=kind_, x0=x0, src=src_, dst=dst_, ptv=ptv_,
                    pv=pv_, pf=pf_, pt=pt_, ppx=ppx, ppy=ppy, iters=iters)
        return x0.clone(), 3, 1.0

    monkeypatch.setattr(bundle, "takes_kernel", lambda dev, n: True)
    monkeypatch.setattr(cuda_lm, "lm_minimize", stand_in)
    timer = log.StageTimer(sync=False)
    with timer.active():
        out = bundle.bundle_adjust(*problem, 7, kind)
    assert timer.counts() == {"lm_fused": 1, "lm_iters": 3}
    assert set(timer.summary()) == {"lm_step"}
    K = cuda_lm.PARAMS_PER_CAMERA[kind]
    assert seen["kind"] == kind and seen["iters"] == 7
    assert seen["x0"].shape == (3 * K,)
    assert torch.equal(seen["x0"].reshape(3, K)[:, 0], cams.focal)
    for k, want in (("src", src), ("dst", dst), ("ptv", ptv), ("pv", pv),
                    ("pf", pf), ("pt", pt)):
        assert torch.equal(seen[k], want), k
    if kind == "ray":
        assert torch.equal(seen["ppx"], cams.ppx)
        assert torch.equal(seen["ppy"], cams.ppy)
    else:
        assert seen["ppx"] is None and seen["ppy"] is None
    # x0 back unchanged: the cameras are the inputs up to the Rodrigues
    # round trip, camera 0 exactly re-anchored
    assert torch.equal(out.focal, cams.focal)
    assert torch.allclose(out.R, cams.R, atol=1e-5)
    assert torch.allclose(out.R[0], cams.R[0], atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    _no_build(monkeypatch)
    cams, src, dst, ptv, pf, pt, pv = bundle_problem(2, [(0, 1)], 16)
    x0 = torch.zeros(8)
    args = (src, dst, ptv, pv, pf, pt, cams.ppx, cams.ppy, 5)
    n0 = cuda_lm.launch_count
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lm.lm_minimize("ray", x0, *args)
    with pytest.raises(ValueError, match="residual"):
        cuda_lm.lm_minimize("affine", x0, *args)
    with pytest.raises(ValueError, match="parameters"):
        cuda_lm.lm_minimize("ray", torch.zeros(132), *args)
    with pytest.raises(ValueError, match="parameters"):
        cuda_lm.lm_minimize("reproj", x0, *args)       # 8 is not N·7
    with pytest.raises(ValueError, match="ppx"):
        cuda_lm.lm_minimize("ray", x0, *args[:6], None, None, 5)
    with pytest.raises(ValueError, match="expected"):
        cuda_lm.lm_minimize("ray", x0, src[:, :8], *args[1:])
    assert cuda_lm.launch_count == n0
