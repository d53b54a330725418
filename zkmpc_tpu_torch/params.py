"""Curve and field constants of the PyTorch port.

The port's own copy of the constants it uses from ``zkmpc_tpu/params.py``
(the port imports nothing of ``zkmpc_tpu``).  All values are plain Python
integers (public mathematical constants), matching the parameter set used
by the reference implementation:

- BLS12-377 (SNARK curve): reference `arkworks/curves/bls12_377/src/fields/{fr,fq}.rs`,
  `curves/{g1,g2}.rs`.
- ed-on-bls12-377 scalar field (twisted Edwards over BLS12-377 Fr):
  reference `arkworks/curves/ed_on_bls12_377/src/fields/fr.rs`.
- MNT4-753 Fq (reused as the SHE ciphertext coefficient modulus):
  reference `arkworks/curves/mnt4_753/src/fields/fq.rs`, `src/she.rs:17`.
"""

# --------------------------------------------------------------------------
# BLS12-377
# --------------------------------------------------------------------------

# BLS parameter x (positive).
BLS_X = 0x8508C00000000001

# Scalar field Fr: 253 bits, 2-adicity 47, generator 22.
FR_MODULUS = 8444461749428370424248824938781546531375899335154063827935233455917409239041
FR_GENERATOR = 22
FR_TWO_ADICITY = 47

# Base field Fq: 377 bits, 2-adicity 46, generator -5.
FQ_MODULUS = 258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177
FQ_GENERATOR = -5
FQ_TWO_ADICITY = 46

assert FR_MODULUS.bit_length() == 253
assert FQ_MODULUS.bit_length() == 377
assert (FR_MODULUS - 1) % (1 << FR_TWO_ADICITY) == 0
assert (FQ_MODULUS - 1) % (1 << FQ_TWO_ADICITY) == 0

# G1: y^2 = x^3 + 1 over Fq.
G1_GENERATOR_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_GENERATOR_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030

# Fq2 = Fq[u] / (u^2 - NONRESIDUE), NONRESIDUE = -5.
FQ2_NONRESIDUE = FQ_MODULUS - 5
# Fq6 = Fq2[v] / (v^3 - u); Fq12 = Fq6[w] / (w^2 - v).  (c0, c1) pairs below.

# G2: y^2 = x^3 + b' over Fq2, D-type twist, b' = b / u.
G2_GENERATOR_X_C0 = 233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294
G2_GENERATOR_X_C1 = 140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118
G2_GENERATOR_Y_C0 = 63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423
G2_GENERATOR_Y_C1 = 149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491

# --------------------------------------------------------------------------
# ed-on-bls12-377: scalar field (251 bits, generator 5, 2-adicity 1).
# --------------------------------------------------------------------------

ED_FR_MODULUS = 2111115437357092606062206234695386632838870926408408195193685246394721360383
ED_FR_GENERATOR = 5

assert ED_FR_MODULUS.bit_length() == 251

# --------------------------------------------------------------------------
# MNT4-753 Fq — the SHE ciphertext modulus q (753 bits, 2-adicity 15, generator 17).
# --------------------------------------------------------------------------

MNT4753_FQ_MODULUS = 41898490967918953402344214791240637128170709919953949071783502921025352812571106773058893763790338921418070971888253786114353726529584385201591605722013126468931404347949840543007986327743462853720628051692141265303114721689601
MNT4753_FQ_GENERATOR = 17
MNT4753_FQ_TWO_ADICITY = 15

assert MNT4753_FQ_MODULUS.bit_length() == 753
assert (MNT4753_FQ_MODULUS - 1) % (1 << MNT4753_FQ_TWO_ADICITY) == 0
