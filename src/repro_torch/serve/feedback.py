"""Cost-feedback recalibration — the §5 estimation loop closed online.

Port of ``repro/serve/feedback.py``, verbatim on the port's planner: the
same observed costs give the same factors.

The paper's workflow estimates (D_s1, Q_bc, D_s2) from a local sample and
a statistical model, decides once, and stops.  A serving system sees the
*observed* :class:`~repro_torch.core.strategies.StrategyCost` of every execution
(S1's exact label-matched edge count; S2's executor-measured broadcast and
unicast symbols) and can correct its estimates for the next request.

Calibration is kept per **label class** — the sorted set of labels in the
query plus its wildcard flag — following Casel & Schmid's observation
(PAPERS.md) that RPQ cost structure is a property of the query class, not
the query string: ``{C}+ acetylation {A}+`` and ``{C} acetylation {A}``
share label statistics, and their estimation errors are correlated.

Each channel (d_s1, q_bc, d_s2) keeps an EWMA of the *target factor*
``observed / raw-forecast`` — the ratio against the planner's un-calibrated
estimate, so the factors converge to the true correction instead of
compounding on top of previously applied scales.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import planner
from repro_torch.core import regex as rx
from repro_torch.core.strategies import StrategyCost


def label_class_key(ast: rx.Node) -> tuple:
    """The calibration bucket of a query: (sorted labels, wildcard flag)."""
    return (tuple(sorted(rx.labels_of(ast))), rx.has_wildcard(ast))


@dataclasses.dataclass(frozen=True)
class CalibrationFactors:
    """Multiplicative corrections applied to the planner's raw estimates."""

    d_s1: float = 1.0
    q_bc: float = 1.0
    d_s2: float = 1.0


class Calibrator:
    """Per-label-class EWMA calibration of the planner's cost estimates.

    ``decay`` is the EWMA step (0 = frozen, 1 = last observation wins);
    ``clamp`` bounds each factor so one pathological execution cannot
    swing future planning by orders of magnitude.
    """

    def __init__(self, decay: float = 0.3, clamp: tuple[float, float] = (0.2, 5.0)):
        self.decay = decay
        self.clamp = clamp
        self._factors: dict[tuple, dict[str, float]] = {}
        self.n_observations = 0

    # -- reads --------------------------------------------------------------

    def factors(self, key: tuple) -> CalibrationFactors:
        f = self._factors.get(key)
        if not f:
            return CalibrationFactors()
        return CalibrationFactors(
            d_s1=f.get("d_s1", 1.0), q_bc=f.get("q_bc", 1.0), d_s2=f.get("d_s2", 1.0)
        )

    # -- updates ------------------------------------------------------------

    def _update(self, key: tuple, channel: str, target: float) -> None:
        lo, hi = self.clamp
        target = float(np.clip(target, lo, hi))
        slot = self._factors.setdefault(key, {})
        prev = slot.get(channel, 1.0)
        slot[channel] = (1.0 - self.decay) * prev + self.decay * target

    def observe(
        self,
        key: tuple,
        estimates: planner.PlanEstimates,
        plan: planner.QueryPlan,
        observed: StrategyCost,
    ) -> None:
        """Fold one execution's observed cost back into the factors.

        Ratios are taken against the *raw* (un-calibrated) estimates in
        ``estimates``, at the plan's decision quantile for S2.
        """
        self.n_observations += 1
        if observed.strategy == "S1":
            if estimates.d_s1 > 0 and observed.unicast_symbols > 0:
                self._update(key, "d_s1", observed.unicast_symbols / estimates.d_s1)
            return
        # S2: compare against the raw decision-quantile forecast
        _, q_bc_raw, d_s2_raw = planner.calibrated_samples(estimates)
        dq = plan.decision_quantile
        q_bc_fc = float(np.quantile(q_bc_raw, dq))
        d_s2_fc = float(np.quantile(d_s2_raw, dq))
        if q_bc_fc > 0 and observed.broadcast_symbols > 0:
            self._update(key, "q_bc", observed.broadcast_symbols / q_bc_fc)
        if d_s2_fc > 0 and observed.unicast_symbols > 0:
            self._update(key, "d_s2", observed.unicast_symbols / d_s2_fc)

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        return {
            "n_observations": self.n_observations,
            "n_label_classes": len(self._factors),
            "factors": {
                "|".join(k[0]) + ("|." if k[1] else ""): dict(v)
                for k, v in self._factors.items()
            },
        }
