"""Rotation-warper projection math (`imagestitch_tpu.warp.projectors`):
each projector maps source pixels to surface coordinates (forward:
ray = R·K⁻¹·[x, y, 1]) and surface coordinates back to source pixels
(backward: K·R⁻¹·ray with a perspective divide, valid where z > 0).

All eleven kinds of the JAX package: the cylindrical, spherical and
plane projectors, which the warp kernel (`ops.cuda_warp`) carries, and
OpenCV's fisheye, stereographic, Mercator, transverse Mercator,
compressed-rectilinear and Panini projectors, which the pipeline warps
with the plain `warp.warper.warp_image`, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def k_inverse(K: torch.Tensor) -> torch.Tensor:
    """K⁻¹ of an upper-triangular intrinsic matrix, rounded as the JAX
    package's LU solve rounds it: back substitution that multiplies by the
    diagonal's reciprocals (K⁻¹[0, 2] = -ppx·(1/f), where a division would
    give -ppx/f). The forward map's ROI takes its last bit from this: with
    R = I and the plane warp, u0 = f·K⁻¹[0, 2] lands on -ppx or just below
    it, and the canvas corner is its floor."""
    K = K.to(torch.float32)
    r = 1.0 / torch.diagonal(K)
    zero = torch.zeros((), dtype=torch.float32, device=K.device)
    x12 = (zero - K[1, 2] * r[2]) * r[1]
    x01 = (zero - K[0, 1] * r[1]) * r[0]
    x02 = (zero - K[0, 1] * x12 - K[0, 2] * r[2]) * r[0]
    return torch.stack([torch.stack([r[0], x01, x02]),
                        torch.stack([zero, r[1], x12]),
                        torch.stack([zero, zero, r[2]])])


def _camera_mats(K: torch.Tensor, R: torch.Tensor):
    """r_kinv = R·K⁻¹ (forward) and k_rinv = K·R⁻¹ (backward; the general
    inverse, so non-orthogonal chained R stay correct)."""
    K = K.to(torch.float32)
    R = R.to(torch.float32)
    return R @ k_inverse(K), K @ torch.linalg.inv(R)


def _ray(r_kinv, x, y):
    X = r_kinv[0, 0] * x + r_kinv[0, 1] * y + r_kinv[0, 2]
    Y = r_kinv[1, 0] * x + r_kinv[1, 1] * y + r_kinv[1, 2]
    Z = r_kinv[2, 0] * x + r_kinv[2, 1] * y + r_kinv[2, 2]
    return X, Y, Z


def _project(k_rinv, X, Y, Z):
    """K·R⁻¹ projection with z > 0 validity."""
    x = k_rinv[0, 0] * X + k_rinv[0, 1] * Y + k_rinv[0, 2] * Z
    y = k_rinv[1, 0] * X + k_rinv[1, 1] * Y + k_rinv[1, 2] * Z
    z = k_rinv[2, 0] * X + k_rinv[2, 1] * Y + k_rinv[2, 2] * Z
    valid = z > 0
    zsafe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return x / zsafe, y / zsafe, valid


class Projector:
    """Base: subclasses define the surface <-> ray maps."""

    def __init__(self, K, R, scale):
        self.scale = torch.as_tensor(scale, dtype=torch.float32,
                                     device=K.device)
        self.r_kinv, self.k_rinv = _camera_mats(K, R)

    @classmethod
    def from_backward(cls, k_rinv: torch.Tensor, scale) -> "Projector":
        """A projector that only maps backward, from K·R⁻¹ itself."""
        p = cls.__new__(cls)
        p.scale = torch.as_tensor(scale, dtype=torch.float32,
                                  device=k_rinv.device)
        p.r_kinv, p.k_rinv = None, k_rinv.to(torch.float32)
        return p

    def forward(self, x, y):
        X, Y, Z = _ray(self.r_kinv, x, y)
        return self._surface_from_ray(X, Y, Z)

    def backward(self, u, v):
        X, Y, Z = self._ray_from_surface(u, v)
        return _project(self.k_rinv, X, Y, Z)


class CylindricalProjector(Projector):
    """u = s·atan2(x̂, ẑ), v = s·ŷ/√(x̂²+ẑ²); backward (sin u, v, cos u)."""

    def _surface_from_ray(self, X, Y, Z):
        u = self.scale * torch.atan2(X, Z)
        denom = torch.sqrt(X * X + Z * Z)
        v = self.scale * Y / denom.clamp(min=1e-12)
        return u, v

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        return torch.sin(u), v, torch.cos(u)


class SphericalProjector(Projector):
    """u = s·atan2(x̂, ẑ), v = s·(π − acos(ŷ/|r|))."""

    def _surface_from_ray(self, X, Y, Z):
        u = self.scale * torch.atan2(X, Z)
        norm = torch.sqrt(X * X + Y * Y + Z * Z)
        w = (Y / norm.clamp(min=1e-12)).clamp(-1.0, 1.0)
        v = self.scale * (PI - torch.acos(w))
        return u, v

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        sinv = torch.sin(PI - v)
        return sinv * torch.sin(u), torch.cos(PI - v), sinv * torch.cos(u)


class PlaneProjector(Projector):
    """u = s·x̂/ẑ, v = s·ŷ/ẑ."""

    def _surface_from_ray(self, X, Y, Z):
        zsafe = torch.where(Z.abs() < 1e-12, torch.full_like(Z, 1e-12), Z)
        return self.scale * X / zsafe, self.scale * Y / zsafe

    def _ray_from_surface(self, u, v):
        return u / self.scale, v / self.scale, torch.ones_like(u)


def _polar_angle(X, Y, Z):
    """(azimuth atan2(x̂, ẑ), π − acos(ŷ/|r|)) of rays."""
    norm = torch.sqrt(X * X + Y * Y + Z * Z)
    w = (Y / norm.clamp(min=1e-12)).clamp(-1.0, 1.0)
    return torch.atan2(X, Z), PI - torch.acos(w)


def _ray_from_polar(u_, v_):
    sinv = torch.sin(PI - v_)
    return sinv * torch.sin(u_), torch.cos(PI - v_), sinv * torch.cos(u_)


class FisheyeProjector(Projector):
    """Equidistant fisheye: the polar angle times the azimuth direction."""

    def _surface_from_ray(self, X, Y, Z):
        u_, v_ = _polar_angle(X, Y, Z)
        return self.scale * v_ * torch.cos(u_), self.scale * v_ * torch.sin(u_)

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        return _ray_from_polar(torch.atan2(v, u), torch.sqrt(u * u + v * v))


class StereographicProjector(Projector):
    """Stereographic: r = sin v_ / (1 − cos v_) along the azimuth."""

    def _surface_from_ray(self, X, Y, Z):
        u_, v_ = _polar_angle(X, Y, Z)
        r = torch.sin(v_) / (1.0 - torch.cos(v_)).clamp(min=1e-12)
        return self.scale * r * torch.cos(u_), self.scale * r * torch.sin(u_)

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        r = torch.sqrt(u * u + v * v)
        return _ray_from_polar(torch.atan2(v, u),
                               2.0 * torch.atan(1.0 / r.clamp(min=1e-12)))


def _sphere_angles(X, Y, Z):
    """(azimuth u_, latitude v_ = asin(ŷ/|r|)): the convention of the
    Mercator, transverse Mercator, compressed-rectilinear and Panini
    projectors."""
    norm = torch.sqrt(X * X + Y * Y + Z * Z)
    return (torch.atan2(X, Z),
            torch.asin((Y / norm.clamp(min=1e-12)).clamp(-1.0, 1.0)))


def _ray_from_angles(u_, v_):
    cosv = torch.cos(v_)
    return cosv * torch.sin(u_), torch.sin(v_), cosv * torch.cos(u_)


class MercatorProjector(Projector):
    """u = s·u_, v = s·ln tan(π/4 + v_/2); inverse v_ = atan(sinh v)."""

    def _surface_from_ray(self, X, Y, Z):
        u_, v_ = _sphere_angles(X, Y, Z)
        return (self.scale * u_,
                self.scale * torch.log(torch.tan(PI / 4 + v_ / 2)))

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        return _ray_from_angles(u, torch.atan(torch.sinh(v)))


class TransverseMercatorProjector(Projector):
    """b = cos v_·sin u_; u = (s/2)·ln((1+b)/(1−b)), v = s·atan2(tan v_,
    cos u_); inverse v_ = asin(sin v / cosh u), u_ = atan2(sinh u, cos v)."""

    def _surface_from_ray(self, X, Y, Z):
        u_, v_ = _sphere_angles(X, Y, Z)
        b = (torch.cos(v_) * torch.sin(u_)).clamp(-1.0 + 1e-7, 1.0 - 1e-7)
        return (self.scale / 2 * torch.log((1.0 + b) / (1.0 - b)),
                self.scale * torch.atan2(torch.tan(v_), torch.cos(u_)))

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        v_ = torch.asin((torch.sin(v) / torch.cosh(u)).clamp(-1.0, 1.0))
        u_ = torch.atan2(torch.sinh(u), torch.cos(v))
        return _ray_from_angles(u_, v_)


class CompressedRectilinearProjector(Projector):
    """u = s·a·tan(u_/a), v = s·b·tan v_ / cos u_ (kinds
    compressedPlaneA{2,1.5}B1)."""

    a: float = 1.0
    b: float = 1.0

    def _surface_from_ray(self, X, Y, Z):
        u_, v_ = _sphere_angles(X, Y, Z)
        return (self.scale * self.a * torch.tan(u_ / self.a),
                self.scale * self.b * torch.tan(v_) / torch.cos(u_))

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        u_ = self.a * torch.atan(u / self.a)
        return _ray_from_angles(u_, torch.atan(v * torch.cos(u_) / self.b))


class PaniniProjector(Projector):
    """u = s·a·tan(u_/a), v = s·b·(a·tan(u_/a))·tan v_ / sin u_, with the
    sin u_ → 0 limit b·tan v_ (kinds paniniA{2,1.5}B1)."""

    a: float = 1.0
    b: float = 1.0

    def _surface_from_ray(self, X, Y, Z):
        u_, v_ = _sphere_angles(X, Y, Z)
        tg = self.a * torch.tan(u_ / self.a)
        sinu = torch.sin(u_)
        small = sinu.abs() < 1e-7
        one = torch.ones_like(sinu)
        ratio = torch.where(small, one, tg / torch.where(small, one, sinu))
        return self.scale * tg, self.scale * self.b * ratio * torch.tan(v_)

    def _ray_from_surface(self, u, v):
        u = u / self.scale
        v = v / self.scale
        lam = self.a * torch.atan(u / self.a)
        small = lam.abs() < 1e-7
        denom = self.b * self.a * torch.tan(
            torch.where(small, torch.ones_like(lam), lam) / self.a)
        t = torch.where(small, v / self.b, v * torch.sin(lam) / denom)
        return _ray_from_angles(lam, torch.atan(t))


def _with_ab(cls, a, b):
    return type(f"{cls.__name__}_a{a}b{b}", (cls,), {"a": a, "b": b})


PROJECTORS = {
    "cylindrical": CylindricalProjector,
    "spherical": SphericalProjector,
    "plane": PlaneProjector,
    "fisheye": FisheyeProjector,
    "stereographic": StereographicProjector,
    "mercator": MercatorProjector,
    "transverseMercator": TransverseMercatorProjector,
    "compressedPlaneA2B1": _with_ab(CompressedRectilinearProjector, 2.0, 1.0),
    "compressedPlaneA1.5B1": _with_ab(
        CompressedRectilinearProjector, 1.5, 1.0),
    "paniniA2B1": _with_ab(PaniniProjector, 2.0, 1.0),
    "paniniA1.5B1": _with_ab(PaniniProjector, 1.5, 1.0),
}
