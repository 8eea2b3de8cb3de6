"""Discretized-gamma rate heterogeneity.

Counterpart of the reference's makeDiscretizedGammaModel
(/root/reference/src/gamma.cpp:5-32): an N-bin equal-weight mixture whose
rate multipliers are inverse-gamma-CDF quantiles at (c+1)/(bins+1),
mean-normalized to 1.  On the device the resulting mixture components shard
naturally across devices (expert-parallel analogue, SURVEY.md 2.7).
"""

from __future__ import annotations

import numpy as np

from historian_tpu.models.ratemodel import RateModel


def make_discretized_gamma_model(model: RateModel, bins: int, shape: float) -> RateModel:
    # deferred: scipy.stats costs ~1s of import time, only -gamma needs it
    from scipy.stats import gamma as gamma_dist

    if model.components != 1:
        raise ValueError("can't make a discretized gamma model from an existing mixture model")
    q = (np.arange(1, bins + 1)) / (bins + 1)
    mult = gamma_dist.ppf(q, a=shape, scale=1.0 / shape)
    mult = mult / mult.mean()
    return RateModel(
        alphabet=model.alphabet,
        ins_rate=model.ins_rate,
        del_rate=model.del_rate,
        ins_ext_prob=model.ins_ext_prob,
        del_ext_prob=model.del_ext_prob,
        cpt_weight=np.full(bins, 1.0 / bins),
        ins_prob=np.repeat(model.ins_prob, bins, axis=0),
        sub_rate=model.sub_rate[0][None, :, :] * mult[:, None, None],
    )
