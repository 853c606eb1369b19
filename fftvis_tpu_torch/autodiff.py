"""Differentiable visibility simulation (gradient-based calibration).

The port of ``fftvis_tpu/autodiff.py`` to ``torch.autograd``: the same two
front-ends, each returning ``(sim_fn, params)`` where ``sim_fn(params)`` is
the visibility tensor ``(nfreqs, ntimes[, 2, 2], nbls)`` and ``params`` a
dict of tensors that require a gradient. ``torch.autograd.grad`` (or
``loss.backward()``) and ``torch.optim`` take the place of ``jax.grad``
and optax::

    sim_fn, params = build_differentiable_sim(
        ants, fluxes, ra, dec, freqs, times, beam, telescope_loc,
        polarized=..., ...,
    )
    vis = sim_fn(params)                     # == simulate_vis(...) output
    loss = (sim_fn(params) - data).abs().pow(2).sum()
    grads = torch.autograd.grad(loss, list(params.values()))

:func:`build_differentiable_sim` runs the engine's own device loop
(``cuda/engine.py`` with ``return_program``), with the fluxes -> coherency
map rebuilt from the parameter each call (``core/coherency.py``
``coherency_tensor``; never cached) and, with ``differentiate_beam``, the
stacked per-antenna beam table taken from the parameter. On the card the
loop's hand-written kernels run forward and their adjoints run backward,
through their ``torch.autograd.Function`` s: spread and interp
(``nufft/``), the stacked table's interpolation, the fused source block
and the pair rows (``beams/eval.py``). Parameters:

- ``params["fluxes"]`` always (Stokes I or IQUV, float64, as handed in);
- ``params["beam_table"]`` with ``differentiate_beam=True`` and two or
  more tabulated beams on one az/za grid: the stacked (nfreq, ny, nx, K *
  chflat) table the engine interpolates (the per-antenna calibration
  scenario). With auto-rank (precision 1, a polarized list of 8 beam
  pairs or more) it is the eigenbeam table, as in the JAX package;
- ``params["gains"]`` with ``differentiate_gains=True``: per-antenna
  diagonal-Jones gains, real ``(2 re/im, nant, nfreqs[, 2 feeds])``,
  initialised to 1 + 0j, applied in the engine's convention (``[a, b]``
  of baseline (i, j) times ``conj(g_i^b) g_j^a``; on the baselines the
  beam-pair routing flipped, which it conjugates without a feed swap,
  ``conj(g_i^a) g_j^b``), so baking the gains into per-antenna beams and
  using ``params["gains"]`` agree.

Positions, times and frequencies are planning inputs there (the transform's
grids and tap tables are host-planned from them). For gradients in the
geometry -- source ra/dec and antenna positions -- use
:func:`build_differentiable_direct_sim`, a torch tracing of the direct
measurement equation at the oracle's O(nsrc * nbl) cost, one loop over the
times in place of the JAX package's ``lax.scan``.

The port has no double-single path (precision 2 is native float64 on the
card), so the JAX front-end's refusal of it has no counterpart. Multi-device
meshes are a later item: ``mesh=`` raises.

Conditioning caveat for unpolarized beam fitting (as in the JAX package):
the unpolarized path weights sources by ``sqrt(B_i * B_j)``, whose slope is
unbounded where the power beam falls toward zero; fit per-antenna beams
with ``polarized=True`` (the visibility is bilinear in E-field tables).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .wrapper import prepare_beam_list

__all__ = ["build_differentiable_sim", "build_differentiable_direct_sim",
           "params_from_reference"]

_NO_TABLE = (
    "differentiate_beam=True requires the engine's stacked "
    "beam-table input: at least two tabulated (gridded) beams "
    "sharing one az/za grid (the per-antenna calibration "
    "scenario). Analytic beams are closed-form, and a lone "
    "tabulated beam is baked in as a closure constant. Convert "
    "with GriddedBeam.from_function and pass a beam list with "
    "beam_idx."
)


def _make_gain_applier(bl_index, flipped, polarized: bool, device):
    """Closure applying per-antenna diagonal-Jones gains to a visibility
    tensor in the reference output layout, in the engine's convention:
    output ``[a, b]`` of baseline (i, j) is ``<conj(v_i^b) v_j^a>``, so
    gains enter as ``conj(g_i^b) g_j^a``; on baselines the pair routing
    flipped (conjugated without a feed swap, as the reference does) the
    factor is ``conj(g_i^a) g_j^b``. Unpolarized: ``conj(g_i) g_j``."""
    bl_index = np.asarray(bl_index)
    dev = torch.device(device)
    ai = torch.as_tensor(bl_index[:, 0].astype(np.int64), device=dev)
    aj = torch.as_tensor(bl_index[:, 1].astype(np.int64), device=dev)
    flip = torch.as_tensor(np.array(flipped, dtype=bool), device=dev)

    def apply_gains(vis, gains):
        gc = torch.complex(gains[0], gains[1])  # (nant, nfreqs[, 2])
        gi, gj = torch.conj(gc[ai]), gc[aj]  # (nbl, nfreqs[, 2])
        if polarized:
            # vis (nfreqs, ntimes, a, b, nbl).
            gi_f, gj_f = gi.permute(1, 2, 0), gj.permute(1, 2, 0)  # (nfreqs, feed, nbl)

            def on_a(g):
                return g[:, None, :, None, :]

            def on_b(g):
                return g[:, None, None, :, :]

            fac = torch.where(flip, on_a(gi_f) * on_b(gj_f), on_b(gi_f) * on_a(gj_f))
            return vis * fac.to(vis.dtype)
        return vis * (gi * gj).T[:, None, :].to(vis.dtype)  # (nfreqs, 1, nbl)

    return apply_gains


def _init_gains(nant: int, nfreqs: int, polarized: bool, dtype, device) -> torch.Tensor:
    """Unity per-antenna gains in the (re, im)-stacked storage layout."""
    shape = (2, nant, nfreqs) + ((2,) if polarized else ())
    g0 = torch.zeros(shape, dtype=dtype, device=device)
    g0[0] = 1.0
    return g0.requires_grad_()


def _param(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device).requires_grad_()


def build_differentiable_sim(
    ants: dict,
    fluxes: np.ndarray,
    ra: np.ndarray,
    dec: np.ndarray,
    freqs: np.ndarray,
    times,
    beam,
    telescope_loc,
    beam_idx: np.ndarray | None = None,
    baselines: list | None = None,
    precision: int = 2,
    polarized: bool = False,
    eps: float | None = None,
    upsample_factor=2,
    beam_spline_opts: dict | None = None,
    use_feed: str = "x",
    flat_array_tol: float = 1e-6,
    interpolation_function: str = "az_za_map_coordinates",
    coord_method: str = "CoordinateRotationERFA",
    coord_method_params: dict | None = None,
    force_use_type3: bool = False,
    beam_coefs: np.ndarray | None = None,
    mesh=None,
    differentiate_beam: bool = False,
    differentiate_gains: bool = False,
    nufft_mode: str = "auto",
    device="cuda",
):
    """Build ``(sim_fn, params)``: a differentiable simulation closure.

    Arguments mirror :func:`fftvis_tpu_torch.simulate_vis` (same semantics
    and output layout); ``sim_fn(params)`` returns the complex visibility
    tensor ``(nfreqs, ntimes[, 2, 2], nbls)`` on ``device``, equal to
    ``simulate_vis`` on the same configuration. ``params`` holds
    ``"fluxes"``, and ``"beam_table"`` / ``"gains"`` as asked (see the
    module docstring), each a leaf tensor that requires a gradient.
    ``nufft_mode`` is the engine's (``"type3"`` forces the type-3 kernels
    where the cost model would pick the direct path).
    """
    if mesh is not None:
        raise NotImplementedError("mesh (multi-device runs) is ROADMAP item 10")
    from .cuda.engine import CUDASimulationEngine
    from .core.coherency import coherency_tensor

    ants = {k: np.asarray(v) for k, v in ants.items()}
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    beam_list, beam_idx = prepare_beam_list(
        beam, freqs, polarized, beam_coefs, use_feed, len(ants), beam_idx
    )
    dev = torch.device(device)
    run, inputs, info = CUDASimulationEngine(nufft_mode=nufft_mode, device=dev).simulate(
        ants=ants,
        freqs=freqs,
        fluxes=np.asarray(fluxes),
        beam_list=beam_list,
        beam_idx=beam_idx,
        ra=np.asarray(ra, dtype=float),
        dec=np.asarray(dec, dtype=float),
        times=times,
        telescope_loc=telescope_loc,
        baselines=baselines,
        precision=precision,
        polarized=polarized,
        eps=eps,
        upsample_factor=upsample_factor,
        beam_spline_opts=beam_spline_opts,
        flat_array_tol=flat_array_tol,
        interpolation_function=interpolation_function,
        coord_method=coord_method,
        coord_method_params=coord_method_params,
        force_use_type3=force_use_type3,
        beam_coefs=beam_coefs,
        return_program=True,
    )
    if differentiate_beam and not info["has_beam_table"]:
        raise ValueError(_NO_TABLE)
    coh_i, tab_i = info["coh_index"], info["beam_table_index"]
    apply_gains = _make_gain_applier(info["bl_index"], info["flipped"], polarized, dev)

    def sim_fn(params):
        args = list(inputs)
        args[coh_i] = coherency_tensor(params["fluxes"], info["polarized_sky"],
                                       info["real_dtype"], info["keep_idx"],
                                       info["band_perm"])
        if "beam_table" in params:
            args[tab_i] = params["beam_table"]
        vis = run(*args).permute(1, 0, 2, 3, 4)  # (nfreqs, ntimes, a, b, nbl)
        vis = vis if polarized else vis[:, :, 0, 0, :]
        if "gains" in params:
            vis = apply_gains(vis, params["gains"])
        return vis

    params = {"fluxes": _param(np.asarray(fluxes, dtype=float), torch.float64, dev)}
    if differentiate_beam:
        # A copy: the cached device table never carries a graph.
        params["beam_table"] = inputs[tab_i].detach().clone().requires_grad_()
    if differentiate_gains:
        params["gains"] = _init_gains(len(ants), freqs.size, polarized, info["real_dtype"], dev)
    return sim_fn, params


def params_from_reference(jax_params: dict, params: dict) -> dict:
    """The JAX front-end's ``params`` (as NumPy arrays) as this port's
    tensors, for the same configuration: each entry takes the dtype and
    device of the port's own ``params`` entry (the JAX package's stacked
    ``beam_table`` has the port's (nfreq, ny, nx, K * chflat) layout; its
    gains are float32). Leaf tensors that require a gradient."""
    out = {}
    for key, ref in params.items():
        if key not in jax_params:
            continue
        a = np.asarray(jax_params[key])
        if a.shape != tuple(ref.shape):
            raise ValueError(f"params_from_reference: {key} has shape {a.shape}, the port's "
                             f"{tuple(ref.shape)}")
        out[key] = torch.tensor(a, dtype=ref.dtype, device=ref.device).requires_grad_()
    return out


def build_differentiable_direct_sim(
    ants: dict,
    fluxes: np.ndarray,
    ra: np.ndarray,
    dec: np.ndarray,
    freqs: np.ndarray,
    times,
    beam,
    telescope_loc,
    beam_idx: np.ndarray | None = None,
    baselines: list | None = None,
    precision: int = 2,
    polarized: bool = False,
    beam_spline_opts: dict | None = None,
    use_feed: str = "x",
    interpolation_function: str = "az_za_map_coordinates",
    coord_method: str = "CoordinateRotationERFA",
    differentiate_positions: bool = False,
    differentiate_antpos: bool = False,
    differentiate_beam: bool = False,
    differentiate_gains: bool = False,
    device="cuda",
):
    """Build a direct-summation ``(sim_fn, params)`` differentiable in the
    geometry: source positions and antenna positions, on top of fluxes,
    beam tables and gains.

    A torch tracing of the direct measurement equation (the one the JAX
    package's oracle, ``DirectSimulationEngine``, implements)

        V_(ij)(nu, t) = sum_s  transpose(A_i^H C A_j)
                        * exp(+2 pi i nu (r_j - r_i) . x_s(t) / c)

    end to end: ICRS unit vectors from (ra, dec), aberration and the
    per-time rotation (host-planned matrices), the horizon mask, the beams
    at the rotated (az, za) -- a tabulated beam's interpolation through
    ``BeamEvalFunction``, whose backward gives the table's and the
    coordinates' gradients in one kernel on the card -- the coherency rows
    and the fringe sum, one time at a time. Output
    ``(nfreqs, ntimes[, 2, 2], nbls)``; cost O(nsrc * nbl) a (time, freq).

    ``params`` holds ``"fluxes"``, plus ``"ra"``/``"dec"`` (radians) with
    ``differentiate_positions``, ``"antpos"`` (nant, 3 ENU metres, rows in
    ``list(ants)`` order) with ``differentiate_antpos``, ``"beam_table"``
    with ``differentiate_beam`` (two or more tabulated beams on one grid:
    the stacked table) and ``"gains"`` with ``differentiate_gains``;
    positions in float64, the rest as :func:`build_differentiable_sim`
    gives them. The horizon mask and the below-horizon clamp are
    piecewise constant, and order-1 beam interpolation piecewise linear:
    gradients are exact away from those edges.
    """
    from .beams.interface import prepare_beams, stack_prepared
    from .coords.rotation import SourceRotation, enu_to_az_za
    from .core import utils as core_utils
    from .core.beams import plan_beam_pairs
    from .core.coherency import apparent_coherency_rows, classify_sky, coherency_tensor
    from .core.simulate import resolve_precision

    dev = torch.device(device)
    ants = {k: np.asarray(v, dtype=float) for k, v in ants.items()}
    antnums = list(ants.keys())
    nant = len(antnums)
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    nfreqs = freqs.size
    rdtype, cdtype = resolve_precision(precision)

    beam_list, beam_idx = prepare_beam_list(
        beam, freqs, polarized, None, use_feed, nant, beam_idx
    )
    prepared = prepare_beams(
        beam_list, freqs, polarized, spline_opts=beam_spline_opts,
        interpolation_function=interpolation_function, use_feed=use_feed,
        dtype=rdtype, device=dev,
    )
    stacked = None
    if differentiate_beam:
        stacked = stack_prepared(prepared)
        if stacked is None:
            raise ValueError(
                "differentiate_beam=True requires at least two tabulated "
                "(gridded) beams sharing one az/za grid (the stacked-table "
                "input). Convert with GriddedBeam.from_function and pass a "
                "beam list with beam_idx."
            )

    if baselines is None:
        reds = core_utils.get_pos_reds(ants, include_autos=True)
        baselines = [red[0] for red in reds]
    nbl = len(baselines)
    nfeeds = 2 if polarized else 1
    ai_idx = np.array([antnums.index(b[0]) for b in baselines])
    aj_idx = np.array([antnums.index(b[1]) for b in baselines])
    antpos0 = np.array([ants[a] for a in antnums], dtype=float)  # (nant, 3)

    pair_plan = plan_beam_pairs(antnums, baselines, beam_idx)
    # Per-pair results concatenate along the baseline axis in pair order;
    # pos_of[b] is the column of that concatenation holding baseline b.
    concat_order = np.concatenate([np.asarray(s) for s in pair_plan.bls_idxs])
    pos_of = np.empty(nbl, dtype=np.int64)
    pos_of[concat_order] = np.arange(nbl)
    flipped_global = np.zeros(nbl, dtype=bool)
    for sel, fl in zip(pair_plan.bls_idxs, pair_plan.flipped):
        flipped_global[sel] = fl
    pairs = [(bi, bj, torch.as_tensor(np.asarray(sel, dtype=np.int64), device=dev),
              torch.as_tensor(np.asarray(fl, dtype=bool), device=dev))
             for (bi, bj), sel, fl in zip(pair_plan.pairs, pair_plan.bls_idxs,
                                          pair_plan.flipped)]
    pos_of_t = torch.as_tensor(pos_of, device=dev)
    ai_t = torch.as_tensor(ai_idx.astype(np.int64), device=dev)
    aj_t = torch.as_tensor(aj_idx.astype(np.int64), device=dev)

    fluxes = np.asarray(fluxes, dtype=float)
    polarized_sky = classify_sky(fluxes, polarized)

    rot = SourceRotation(np.asarray(ra, dtype=float), np.asarray(dec, dtype=float), times,
                         telescope_loc, coord_method=coord_method)
    mats = torch.tensor(rot.matrices, dtype=rdtype, device=dev)  # (nt, 3, 3)
    vels = torch.tensor(np.zeros((rot.ntimes, 3)) if rot.aberration is None
                        else rot.aberration, dtype=rdtype, device=dev)
    ra0, dec0 = np.asarray(ra, dtype=float), np.asarray(dec, dtype=float)
    apply_gains = _make_gain_applier(np.stack([ai_idx, aj_idx], axis=1), flipped_global,
                                     polarized, dev)
    consts = {"antpos": torch.tensor(antpos0, device=dev), "ra": torch.tensor(ra0, device=dev),
              "dec": torch.tensor(dec0, device=dev)}
    fringe_scale = [2.0 * math.pi * float(f) / core_utils.speed_of_light for f in freqs]

    def sim_fn(params):
        antpos, ra_t, dec_t = (params.get(k, consts[k]).to(rdtype)
                               for k in ("antpos", "ra", "dec"))
        coh = coherency_tensor(params["fluxes"], polarized_sky, rdtype)
        table_in = params.get("beam_table")

        cd = torch.cos(dec_t)
        eq = torch.stack([cd * torch.cos(ra_t), cd * torch.sin(ra_t), torch.sin(dec_t)])
        blvec = (antpos[aj_t] - antpos[ai_t]).T  # (3, nbl)
        vis_t = []
        for t in range(rot.ntimes):
            eqt = eq + vels[t][:, None]
            eqt = eqt / torch.linalg.norm(eqt, dim=0, keepdim=True)
            topo = mats[t] @ eqt  # (3, nsrc)
            up = (topo[2] > 0).to(rdtype)
            az, za = enu_to_az_za(topo[0], topo[1], orientation="uvbeam")
            vis_f = []
            for fi, freq in enumerate(freqs):
                if table_in is not None:
                    evals = stacked.evaluate_all(az, za, float(freq), fi, table_in)
                else:
                    evals = [pb.evaluate(az, za, float(freq), fi) for pb in prepared]
                phase = fringe_scale[fi] * (topo.T @ blvec)  # (nsrc, nbl)
                fringe = torch.complex(torch.cos(phase), torch.sin(phase)).to(cdtype)
                flux_f = coh[:, fi] * (up[:, None, None] if polarized_sky else up)
                parts = []
                for bi, bj, sel, flip in pairs:
                    rows = apparent_coherency_rows(evals[bi], evals[bj], flux_f, polarized,
                                                   polarized_sky).to(cdtype)
                    fr = fringe[:, sel]
                    fr = torch.where(flip[None, :], torch.conj(fr), fr)
                    v = rows @ fr  # (nfeeds^2, nbl_p)
                    v = torch.where(flip[None, :], torch.conj(v), v)
                    # The reference's final feed transpose.
                    parts.append(v.reshape(nfeeds, nfeeds, -1).transpose(0, 1))
                vis_f.append(torch.cat(parts, dim=-1)[..., pos_of_t])
            vis_t.append(torch.stack(vis_f))  # (nfreq, nf, nf, nbl)
        vis = torch.stack(vis_t, dim=1)  # (nfreq, nt, nf, nf, nbl)
        if not polarized:
            vis = vis[:, :, 0, 0, :]
        if "gains" in params:
            vis = apply_gains(vis, params["gains"])
        return vis

    params = {"fluxes": _param(fluxes, torch.float64, dev)}
    if differentiate_positions:
        params["ra"] = _param(ra0, torch.float64, dev)
        params["dec"] = _param(dec0, torch.float64, dev)
    if differentiate_antpos:
        params["antpos"] = _param(antpos0, torch.float64, dev)
    if differentiate_beam:
        params["beam_table"] = stacked.table.detach().clone().requires_grad_()
    if differentiate_gains:
        params["gains"] = _init_gains(nant, nfreqs, polarized, rdtype, dev)
    return sim_fn, params
