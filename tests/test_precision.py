"""Precision policy (DESIGN.md §2a): every matrix product or convolution
with two f32 operands on the main path names Precision.HIGHEST, so no
backend may run it in a reduced format (TF32 on a GPU keeps about three
decimal digits). bf16 x bf16 -> f32 and int8 x int8 -> i32 products are
exact by construction and may name none."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from video_stab_tpu.core.chain import (ChainParams, chain_state_init,
                                       chain_step_fn)
from video_stab_tpu.core.params import (EnhancerParams, ModeParams,
                                        RollCorrectionParams,
                                        StabilizerParams)
from video_stab_tpu.core.stabilizer import stabilizer_step_fn
from video_stab_tpu.core.state import stabilizer_state_init

SMALL = StabilizerParams(smoothing_radius=5, analysis_width=64,
                         analysis_height=48, max_corners=32,
                         ransac_hypotheses=32)
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
PRODUCTS = ("dot_general", "conv_general_dilated")


def _products(jaxpr, found):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in PRODUCTS:
            found.append(eqn)
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _products(sub.jaxpr, found)
                elif isinstance(sub, jcore.Jaxpr):
                    _products(sub, found)
    return found


def _chain_jaxpr():
    params = ChainParams(
        mode=ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                        stabilizer_enabled=True),
        enhancer=EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        roll=RollCorrectionParams(), stabilizer=SMALL)
    state = chain_state_init(params, 96, 128)
    frame = jnp.zeros((96, 128, 3), jnp.uint8)
    return jax.make_jaxpr(lambda s, f: chain_step_fn(params, s, f))(
        state, frame)


def _homography_jaxpr():
    params = dataclasses.replace(SMALL, motion_model="homography")
    state = stabilizer_state_init(params, 96, 128)
    frame = jnp.zeros((96, 128, 3), jnp.uint8)
    return jax.make_jaxpr(lambda s, f: stabilizer_step_fn(params, s, f))(
        state, frame)


@pytest.mark.parametrize("build", [_chain_jaxpr, _homography_jaxpr],
                         ids=["fused_chain", "homography_step"])
def test_f32_products_name_highest(build):
    found = _products(build().jaxpr, [])
    f32 = [e for e in found
           if all(v.aval.dtype == jnp.float32 for v in e.invars)]
    assert f32, "no f32 products traced: the walk missed the step body"
    loose = [(e.primitive.name, e.params.get("precision"))
             for e in f32 if e.params.get("precision") != HIGHEST]
    assert not loose, loose


def test_reduced_operand_products_accumulate_exactly():
    """The bf16 one-hot slab select (ops/lk.py) and the int8 Hough
    histogram (ops/hough.py) stay reduced-precision operands with a wide
    accumulator — exact for 0/1 weights — and the chain traces both."""
    found = _products(_chain_jaxpr().jaxpr, [])
    kinds = {(str(e.invars[0].aval.dtype), str(e.invars[1].aval.dtype),
              str(e.params.get("preferred_element_type")))
             for e in found if e.primitive.name == "dot_general"}
    assert ("bfloat16", "bfloat16", "float32") in kinds, kinds
