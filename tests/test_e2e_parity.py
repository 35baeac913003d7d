"""Reference test-suite parity: real Groth16 setup/prove/verify through
the credential API (zklaim/tests/zklaim.cpp; SURVEY.md §4).

Includes the reference's DISABLED/TODO adversarial cases
(tests/zklaim.cpp:355-369) as live tests: mismatching payloads, forged
signature, forged in-circuit values, invalid proof.

Setup/prove are shared per payload-count through module fixtures --
these run the REAL pipeline (no mocks), matching the reference's test
style.
"""

import copy
import os
import random

import jax
import pytest

from zklaim_tpu.claims import signing
from zklaim_tpu.claims.api import (
    Context,
    Payload,
    ZKLAIM_ERROR,
    ZKLAIM_INVALID_PROOF,
    ZKLAIM_INVALID_SIGNATURE,
    ZKLAIM_OK,
    ZkOp,
)

# The real SHA256 credential circuit (~28k constraints, 25k vars) is
# accelerator-scale work; on the CPU test platform a single prove takes
# tens of minutes.  Run with ZKLAIM_TEST_PLATFORM=gpu (or ZKLAIM_E2E=1 to
# force it on the CPU).  The default `pytest tests/` stays fast.
pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", autouse=True)
def _accelerator():
    if jax.default_backend() == "cpu" and not os.environ.get("ZKLAIM_E2E"):
        pytest.skip("full-circuit Groth16 E2E needs a GPU "
                    "(ZKLAIM_TEST_PLATFORM=gpu) or ZKLAIM_E2E=1")

SEED = 20260818


def _make_payload(attrs, refs, ops):
    pl = Payload()
    for pos, attr in enumerate(attrs):
        assert pl.set_attr(attr, pos) == ZKLAIM_OK
    pl.data_ref = list(refs)
    pl.data_op = list(ops)
    return pl


def _issuer_ctx(num_payloads, rng):
    """Issuer-side context: payloads hashed, setup done, signed."""
    ctx = Context()
    for i in range(num_payloads):
        # mirrors tests/zklaim.cpp can_proof / multipayload attributes
        ctx.add_payload(
            _make_payload(
                attrs=[23 + i, 1, 2, 3, 599],
                refs=[18, 1, 2, 3, 600],
                ops=[ZkOp.GREATER_OR_EQ, ZkOp.EQ, ZkOp.EQ, ZkOp.EQ, ZkOp.LESS],
            )
        )
    ctx.hash_payloads(rng)
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    priv = signing.keygen(rng)
    assert ctx.sign(priv, rng) == ZKLAIM_OK
    return ctx, priv


@pytest.fixture(scope="module")
def one_payload():
    rng = random.Random(SEED)
    return _issuer_ctx(1, rng), rng


@pytest.fixture(scope="module")
def two_payload():
    rng = random.Random(SEED + 1)
    return _issuer_ctx(2, rng), rng


# -- can_proof (tests/zklaim.cpp:222-258) --------------------------------------


def test_can_proof_single_payload(one_payload):
    (ctx, _priv), rng = one_payload
    prover = copy.deepcopy(ctx)
    assert prover.proof_generate(rng) == ZKLAIM_OK
    assert prover.verify() == ZKLAIM_OK


# -- multipayload proofs (tests/zklaim.cpp:260-339) -----------------------------


def test_can_proof_two_payloads(two_payload):
    (ctx, _priv), rng = two_payload
    prover = copy.deepcopy(ctx)
    assert prover.proof_generate(rng) == ZKLAIM_OK
    prover.clear_pres()
    assert prover.verify() == ZKLAIM_OK


# -- zero payloads (tests/zklaim.cpp:341-353) -----------------------------------


def test_can_handle_no_payload():
    rng = random.Random(SEED + 2)
    ctx = Context()
    ctx.hash_payloads(rng)
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    priv = signing.keygen(rng)
    assert ctx.sign(priv, rng) == ZKLAIM_OK
    assert ctx.proof_generate(rng) == ZKLAIM_OK


# -- three-party E2E with blinding (tests/zklaim.cpp:413-504) -------------------


def test_three_party_run(two_payload):
    (ctx, _priv), rng = two_payload
    wire_issuer = ctx.serialize()

    prover, status = Context.deserialize(wire_issuer)
    assert status == ZKLAIM_OK
    prover.pk = ctx.pk                      # pk ships out-of-band
    # pre-proof verify: signature OK, proof missing
    assert prover.verify() == ZKLAIM_INVALID_PROOF
    assert prover.proof_generate(rng) == ZKLAIM_OK
    prover.clear_pres()                     # blind
    wire_prover = prover.serialize()

    verifier, status = Context.deserialize(wire_prover)
    assert status == ZKLAIM_OK
    assert verifier.verify() == ZKLAIM_OK
    # blinded payloads leak nothing
    for pl in verifier.payloads:
        assert pl.pre == bytes(48) and pl.salt == 0 and pl.priv == 1


# -- DISABLED_zklaim adversarial suite, enabled (tests/zklaim.cpp:355-369) ------


def test_detect_forged_signature(one_payload):
    (ctx, _priv), rng = one_payload
    victim = copy.deepcopy(ctx)
    forger_priv = signing.keygen(rng)
    # forger re-signs with their own key but claims the issuer's pub_key
    victim.signature = signing.sign(victim._plain_view(), forger_priv, rng)
    assert victim.verify() == ZKLAIM_INVALID_SIGNATURE
    # flipped signature bits also fail
    tampered = copy.deepcopy(ctx)
    sig = bytearray(tampered.signature)
    sig[7] ^= 0x40
    tampered.signature = bytes(sig)
    assert tampered.verify() == ZKLAIM_INVALID_SIGNATURE


def test_detect_forged_values_in_circuit(one_payload):
    """Prover's attributes violate the predicate -> witness unsatisfied,
    prover aborts (snark.cpp:121-124 early-abort semantics)."""
    (ctx, _priv), rng = one_payload
    cheat = copy.deepcopy(ctx)
    pl = cheat.payloads[0]
    pl.set_attr(15, 0)                       # age 15 < ref 18 with >= op
    # keep the (now wrong) hash: honest hash + lying attrs
    assert cheat.proof_generate(rng) != ZKLAIM_OK

    # rehash to make SHA consistent: predicate still fails
    cheat2 = copy.deepcopy(ctx)
    cheat2.payloads[0].set_attr(15, 0)
    cheat2.payloads[0].hash_payload(rng)
    assert cheat2.proof_generate(rng) != ZKLAIM_OK


def test_rejects_invalid_proof(one_payload):
    (ctx, _priv), rng = one_payload
    prover = copy.deepcopy(ctx)
    assert prover.proof_generate(rng) == ZKLAIM_OK
    assert prover.verify() == ZKLAIM_OK

    # bit-flip inside the serialized proof -> INVALID_PROOF (or reject at parse)
    bad = copy.deepcopy(prover)
    buf = bytearray(bad.proof)
    buf[len(buf) // 2] ^= 1
    bad.proof = bytes(buf)
    assert bad.verify() in (ZKLAIM_INVALID_PROOF, ZKLAIM_ERROR)

    # proof of a different statement (tampered refs) -> INVALID_PROOF
    wrong_stmt = copy.deepcopy(prover)
    wrong_stmt.payloads[0].data_ref = [21, 1, 2, 3, 600]
    res = wrong_stmt.verify()
    assert res in (ZKLAIM_INVALID_SIGNATURE, ZKLAIM_INVALID_PROOF)


def test_can_handle_mismatching_payloads(one_payload):
    """Payload list inconsistent with the pk's circuit size -> clean error."""
    (ctx, _priv), rng = one_payload
    mism = copy.deepcopy(ctx)
    mism.add_payload(
        _make_payload([1, 0, 0, 0, 0], [0] * 5, [ZkOp.NOOP] * 5)
    )
    mism.payloads[-1].hash_payload(rng)
    # pk was generated for 1 payload; proving 2 must fail, not crash
    assert mism.proof_generate(rng) != ZKLAIM_OK
