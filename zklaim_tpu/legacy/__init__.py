"""Legacy/optional capabilities of the reference (SURVEY.md §2.2).

The reference keeps an `other/` directory of components that are excluded
from its build but define optional capabilities: Lamport one-time
signatures, a SHA256 Merkle tree, pre-gcrypt OpenSSL ECDSA over
secp256k1, an object-oriented credential model, and the original
proof-of-concept single-preimage circuit.  This package provides
Framework-native equivalents with the same observable behavior.
"""
