"""zklaim-tpu: a zero-knowledge claim (zk-SNARK credential) framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C/C++ zklaim library (privacy-preserving credentials over Groth16/ALT_BN128):

- zklaim_tpu.ff       BN254 field arithmetic: host golden model + batched
                      16-bit-limb Montgomery arithmetic on the device
- zklaim_tpu.ec       G1/G2 group law (host + batched device code + GPU kernels), ate pairing
- zklaim_tpu.msm      Pippenger multi-scalar multiplication on the device
- zklaim_tpu.ntt      radix-2 NTT/iNTT over Fr for QAP evaluation
- zklaim_tpu.r1cs     constraint-system builder (sparse R1CS)
- zklaim_tpu.gadgets  multipacking / 64-bit comparison / SHA256-compression gadgets
- zklaim_tpu.groth16  Groth16 setup / prove / verify
- zklaim_tpu.claims   credential layer: payloads, contexts, signing, wire format
- zklaim_tpu.parallel device meshes, sharded MSM/NTT, batched multi-device proving
"""

__version__ = "0.1.0"
