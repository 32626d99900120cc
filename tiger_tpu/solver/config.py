"""Solver configuration: tolerances, step-control constants, compat switches.

Mirrors the reference's Parameters struct + event-detector constants
(src/models/model_204.hpp:23-30, src/solver/event_detector.cuh:11-15) plus the
knobs the reference hard-codes.  A frozen dataclass: hashable, so it can be a
static argument of jitted solvers.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # Tolerances / controller (model_204.hpp:24-29; main.cpp:621,633-640)
    rtol: float = 1e-6
    atol: float = 1e-9
    safety: float = 0.9
    min_scale: float = 0.2
    max_scale: float = 10.0

    # Initial step: None => estimate (see controller.initial_step).  Modes:
    #  'per-system'      — SciPy-style estimate from each system's actual y0
    #                      (improvement over the reference);
    #  'global-zero-y0'  — reference parity: ONE h0 for every system, computed
    #                      from a zero state vector (main.cpp:615-641), which
    #                      degenerates to max(1e-6, 0) = 1e-6 for Model 204.
    initial_step: float | None = None
    h0_mode: str = "per-system"

    # Event / stiffness detection (event_detector.cuh:11-15, rk45_kernel.cu:131-170)
    slope_jump_thresh: float = 100.0
    min_step_fraction: float = 1e-6
    # Stiff when reject_count > max_rejects.  The reference uses 5, which
    # misfires badly after the controller has grown h (maxScale=10): resolving
    # a physics kink from a large step needs > 6 shrink-retries, so kink-
    # crossing lanes get flagged "stiff" and sent to Radau (measured 6% of a
    # 2-day Model-204 basin; with 12 the count is zero and total attempts drop
    # ~2x).  Truly stiff systems are still caught by the h < span *
    # min_step_fraction criterion, which a dozen 0.2x shrinks reach quickly.
    # Set 5 for reference behavioral parity.
    max_rejects: int = 12

    # Stability-boundary stiffness detection (Hairer & Wanner DOPRI5, vol II
    # IV.2: the hlamb test).  The reference's detector only fires on
    # REJECTIONS (streak, or h collapsing below span*min_step_fraction,
    # rk45_kernel.cu:160-170) and misses "accept-cruisers": lanes whose step
    # is pinned at the explicit stability boundary with the error estimate
    # just under 1, so they accept tiny steps indefinitely and never reject —
    # measured 16k attempts (30x the healthy median) on marginally-stiff
    # Model-204 hillslopes, each dilating its whole SIMD tile.  Per accepted
    # step, |h*lambda| is estimated from the two t+h stages
    # (h*|k7-k6|/|g7-g6|, a Rayleigh quotient against the dominant
    # eigenvalue); stiff_streak consecutive TESTED accepted steps beyond
    # stiff_hlamb (DP5's negative-real-axis stability bound ~3.3) flag the
    # lane for Radau, with stiff_forgive calm tested steps resetting the
    # streak.  Testing happens every stiff_test_every-th accepted step
    # (power of two; Hairer's NSTIFF, default 1000 in dopri5.f) — the
    # cadence IS the economics: a lane must sustain the boundary for
    # ~stiff_test_every*stiff_streak accepted steps before it flags, so
    # lanes that finish in a few hundred steps never flag even if |h*lambda|
    # is large (e.g. harmless positive/kink-bounded eigenvalues, a known
    # false-positive class of the test), while a genuine grinder pinned at
    # the boundary for 16k steps flags after ~1k.  Slope-cut attempts
    # additionally trip the counter UNCADENCED: the slope-jump guard's
    # absolute threshold sits orders of magnitude above healthy RHS
    # magnitudes for every shipped model, so each cut is unambiguous
    # stiffness evidence — and a throttling treadmill (h halved, step
    # discarded: measured 63-67% of all attempts on marginally-stiff
    # Model-204 hillslopes).  Applies to both RK45 paths identically;
    # disabled under reference_parity (the reference has no such detector).
    stiff_detect: bool = True
    stiff_hlamb: float = 3.25
    stiff_streak: int = 15
    stiff_forgive: int = 6
    stiff_test_every: int = 64
    # With stiff_detect, the h-collapse criterion requires the carried step
    # to sit below the floor (span * min_step_fraction) for this many
    # CONSECUTIVE attempts, instead of the reference's flag-on-first-
    # rejection-below-floor (rk45_kernel.cu:167).  Rationale: the floor is
    # span-proportional, so "persistently below floor" literally means
    # "cannot finish within ~1/min_step_fraction steps" — while a transient
    # kink-resolution dip (measured ~25 attempts on the reference's own
    # 9-month config, where the raw rule flags EVERY lane) recovers well
    # before the streak fills.  The initial ramp-up from a tiny h0 exits in
    # <= ~10 attempts (growth is x10 per accept).
    stiff_floor_streak: int = 64

    # Clamp every attempted step at the next ZOH forcing-sample boundary
    # (and snap the gather index by +5e-4*dt so a lane landing an ulp below
    # a boundary reads the NEW sample its aligned step was aimed at).
    # Forcing is frozen at step-start for all stages (reference parity,
    # rk45_kernel.cu:84-116), so a step that CROSSES a sample boundary
    # integrates the old value through the new interval — an O(h * delta_F)
    # local error the error estimate cannot see (the frozen value is
    # internally consistent).  Measured on the 2-day stiff bench scenario:
    # 0.35 absolute error in h_snow (f64! — scheme error, not rounding) and
    # order-larger h explosions under the 'radau5' estimate (h -> 383 min
    # across 6 unseen rain samples, then violent rejection storms).  With
    # alignment the frozen value is EXACT over every step: the scheme
    # converges to the true ZOH solution, boundary rejection storms vanish,
    # and the kink-halving treadmill (63-67%% of attempts on marginal lanes)
    # disappears.  Cost: steps are bounded by the finest forcing cadence
    # (>= 48 steps per 2-day run at hourly rain — far below typical step
    # counts).  Disabled under reference_parity: the reference steps across
    # boundaries (its artifacts embed the crossing errors).
    forcing_step_align: bool = True

    # Step-shrink factor applied when the error norm is NaN (a stage produced
    # NaN/Inf).  CUDA's fmin(NaN, 1.0) == 1.0 leaves h unchanged in the
    # reference, so NaN steps re-reject at the same h until the stiffness
    # counter trips; 1.0 reproduces that.  The default shrinks like an
    # ordinary worst-case rejection so the solver steps *past* transient NaN
    # regions (SciPy behaves this way), which eliminates spurious stiff flags.
    nan_shrink: float = 0.2

    # Radau consecutive-rejection cap: the reference kernel has NO escape
    # hatch (radau_kernel.cu:44-137 loops forever if steps keep rejecting);
    # we bail out and mark the system failed instead.
    radau_max_rejects: int = 60

    # Radau Newton iteration (radau_step_dense.cuh:90-141)
    newton_max_iter: int = 10
    newton_tol: float = 1e-8

    # Reject (h := h/2) any step whose Newton iteration did not converge
    # within newton_max_iter — RADAU5's rule.  The reference evaluates the
    # embedded error from whatever Z the iteration left behind
    # (radau_step_dense.cuh:141-162): an unconverged Z is not the collocation
    # solution, its "error estimate" is meaningless, and such steps can be
    # silently ACCEPTED with arbitrarily wrong states (measured 0.28 absolute
    # error, 5e4 tolerance units, on the stiff bench scenario).  Not a
    # reference_parity switch: the reference's Radau path is one of the
    # deliberately-fixed-bug areas (SURVEY.md 2.4), and no golden artifact
    # exercises it.
    newton_reject_unconverged: bool = True

    # Newton starting values from the PREVIOUS attempt's collocation
    # polynomial (Hairer's RADAU5 W-extrapolation, H&W vol II IV.8): the new
    # stage slopes start at the Lagrange evaluation of the last attempt's
    # converged slopes at the new stage times — extrapolation past theta=1
    # after an accept, interpolation inside [0,1] after a reject — instead
    # of the reference's flat f(t, y) tile (radau_step_dense.cuh:87).
    # DEFAULT OFF: on genuinely stiff lanes (the only lanes the rung sees)
    # the extrapolated start is WORSE than the f0 tile — measured 15k-82k
    # attempts/lane with ~9.9 sweeps/attempt vs 1.9k-2.6k at 3.2 sweeps
    # without it (round-3 regression: a 30x attempts blowup that cut the
    # two-phase headline 14x).  The stage slopes of a stiff
    # problem change violently between attempts whenever h moves, so the
    # quadratic Lagrange extrapolation seeds Newton outside its basin;
    # tests/test_radau_regression.py enforces the attempts budget.
    radau_predictor: bool = False

    # RADAU5's step-size freeze (H&W vol II IV.8; quot1/quot2 in radau5.f):
    # after an ACCEPTED step whose proposed growth factor lands in
    # [1, radau_h_freeze_hi], keep h exactly unchanged instead of nudging it.
    # Near the accept boundary the controller otherwise oscillates h by a few
    # percent each step, re-rolling the error estimate across the accept
    # threshold (the f32 'radau5' thrash: ~30% rejections); the freeze damps
    # the oscillation, and in RADAU5 proper it also saves refactorizations.
    # 1.0 disables (always apply the factor).
    radau_h_freeze_hi: float = 1.0

    # Cross-step Jacobian/LU reuse in the FUSED Radau kernel (RADAU5's factor
    # economics, H&W vol II IV.8: the reference refactorizes every Newton
    # ITERATION, radau_step_dense.cuh:90-141 — the cost structure this rung
    # exists to beat).  The eigenbasis factors (one real + one complex N x N
    # LU, kernels/radau_pallas.py) are carried across attempts; refresh is
    # BLOCK-gated (any lane of the block votes -> every lane refactorizes at
    # its own current h).  Lanes vote on OBSERVED
    # Newton effort, not a step-size band: >= radau_refresh_sweeps sweeps
    # last attempt (slow contraction = stale factors, RADAU5's theta test
    # by sweep-count proxy), outright Newton failure, or h drifted outside
    # the WIDE safety band [radau_reuse_lo, radau_reuse_hi] x the factored
    # h (divergence guard: a tight band votes on nearly every iteration,
    # because SOME lane of a block is always mid-growth).  Stale factors are
    # a quasi-Newton whose fixed point is unchanged (the residual is exact);
    # honest rejection backstops non-contraction.  Kernel path only; the
    # vmap twin keeps the reference's per-iteration refresh (it is the
    # parity oracle).  DEFAULT OFF: on the earlier wide-vector kernel a
    # single vote in a very wide block fired the refresh on most
    # iterations, and the factorization was a small share of an attempt.
    radau_factor_reuse: bool = False
    radau_reuse_lo: float = 0.25
    radau_reuse_hi: float = 4.0
    radau_refresh_sweeps: int = 5

    # Radau error estimate:
    #   'radau5'    — RADAU5's smoothed estimate (mu/h I - J)^{-1}(f0 + EA.Z)
    #                 with exponent 1/4 and Newton-effort-aware safety
    #                 (tableau.RADAU_MU_REAL note; SciPy's Radau is the same
    #                 algorithm).  Runs the method at its real order-5 step
    #                 economics — measured ~3x fewer attempts than
    #                 'embedded3' on the stiff bench scenario at equal
    #                 accuracy (the global error is ZOH-kink-dominated at
    #                 these tolerances either way).
    #   'embedded3' — consistent order-2-embedded difference, exponent 1/3:
    #                 simple and conservative (h ~ tol^(1/3)); no Jacobian
    #                 use in the estimate.
    #   'reference' — the reference's inconsistent b_alt
    #                 (radau_step_dense.cuh:73-77, exponent 1/5), whose
    #                 O(h*f) error term caps steps near the tolerance — a
    #                 behavioral-parity switch only (tableau.RADAU_E3 note).
    radau_error_mode: str = "embedded3"

    # Safety cap on total attempted steps per system (the reference has none and
    # can loop forever, e.g. the slope-jump halving path never flags stiff).
    # Systems hitting the cap are flagged failed AND stiff (so Radau retries).
    max_steps: int = 1_000_000

    # Dense-output fill: queries consumed in vectorized chunks of this width
    # per inner-loop iteration (monotone cursor per system, queries sorted).
    dense_chunk: int = 8

    # Step-size controller.  'i' is the reference's plain integral control
    # h *= safety * err^(-1/5) (rk45_kernel.cu:118-127).  'pi' adds Lund
    # stabilization (Hairer & Wanner DOPRI5: exponent 1/5 - 0.75*beta on the
    # current error and +beta on the PREVIOUS accepted error): smoother h
    # sequences, fewer accept/reject oscillations near the tolerance — the
    # rejected fraction of attempts drops on forcing-kink-heavy runs.
    # NON-PARITY: step sequences differ from the reference (results agree at
    # controller tolerance).  Applies to both RK45 paths (vmap and kernel).
    controller: str = "i"
    pi_beta: float = 0.04

    # Compensated (Kahan) float32 state accumulation — the tight-tolerance
    # f32 path.  Plain f32 cannot hold the reference's artifact tolerances
    # (rtol 1e-6 / atol 1e-9, src/main.cpp:621): each committed y += dy
    # rounds at ~6e-8*|y|, and over the ~2k steps of a 2-day run that
    # random-walks past the tolerance, so steps reject at the rounding floor.
    # With compensation the commit is exact to the low word (the same
    # TwoSum pattern the kernel already uses for t): carry c holds the lost
    # bits, kh = dy - c; y' = y + kh; c' = (y' - y) - kh.  Stage math stays
    # f32 — its per-stage noise lands in the CONTROLLED error estimate, not
    # the trajectory accumulation.  Applies to both RK45 paths.
    compensated: bool = False

    # True: dense rows for query times <= t0 are prefilled with y0 (sane
    # default).  False: reference parity — such rows keep their zero
    # initialization because the CUDA kernel only fills queries strictly
    # inside (t, t+h] (rk45_kernel.cu:138-148), which is why dense_204_a.csv's
    # t=0 row is all zeros.
    fill_t0_queries: bool = True

    @classmethod
    def reference_parity(cls, **overrides) -> "SolverConfig":
        """Every behavioral-parity switch set to the reference's value.

        Reproduces the CUDA reference's step-for-step behavior (pair with
        ``Model204(safe_pow=False)`` for the NaN-propagating Manning term):
        zero-state global h0, zeros for t<=t0 dense rows, retry-at-same-h on
        NaN errors, the trigger-happy 5-reject stiffness streak, and the
        inconsistent Radau embedded weights.  See README's parity table.
        """
        base = dict(
            h0_mode="global-zero-y0",
            fill_t0_queries=False,
            nan_shrink=1.0,
            max_rejects=5,
            radau_error_mode="reference",
            stiff_detect=False,
            radau_predictor=False,
            forcing_step_align=False,
        )
        base.update(overrides)
        return cls(**base)

    def __post_init__(self):
        if self.h0_mode not in ("per-system", "global-zero-y0"):
            raise ValueError(f"unknown h0_mode: {self.h0_mode}")
        if self.radau_error_mode not in ("radau5", "embedded3", "reference"):
            raise ValueError(f"unknown radau_error_mode: {self.radau_error_mode}")
        if self.dense_chunk < 1:
            raise ValueError("dense_chunk must be >= 1")
        if self.controller not in ("i", "pi"):
            raise ValueError(f"controller must be i|pi, got {self.controller!r}")
        if not 0.0 <= self.pi_beta <= 0.2:
            raise ValueError(f"pi_beta must be in [0, 0.2], got {self.pi_beta}")
        if self.stiff_streak < 1 or self.stiff_forgive < 1:
            raise ValueError("stiff_streak and stiff_forgive must be >= 1")
        if self.stiff_floor_streak < 1:
            raise ValueError("stiff_floor_streak must be >= 1")
        if not 0.0 < self.radau_reuse_lo <= 1.0 <= self.radau_reuse_hi:
            raise ValueError(
                "radau_reuse_lo/hi must bracket 1.0 with lo > 0; got "
                f"[{self.radau_reuse_lo}, {self.radau_reuse_hi}]"
            )
        if self.radau_refresh_sweeps < 1:
            raise ValueError("radau_refresh_sweeps must be >= 1")
        if not 1.0 <= self.radau_h_freeze_hi <= 2.0:
            raise ValueError(
                f"radau_h_freeze_hi must be in [1, 2], got {self.radau_h_freeze_hi}"
            )
        if not self.stiff_hlamb > 0.0:
            raise ValueError(f"stiff_hlamb must be > 0, got {self.stiff_hlamb}")
        e = self.stiff_test_every
        if e < 1 or (e & (e - 1)) != 0:
            # Power of two: the kernel tests cadence with a bitwise AND.
            raise ValueError(
                f"stiff_test_every must be a power of two, got {e}"
            )
