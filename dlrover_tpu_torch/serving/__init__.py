"""The master-side request ledger of the elastic serving arm
(:mod:`manager`, a copy of dlrover_tpu/serving/manager.py), which the
master's servicer builds. The decode engine and its workers are not
ported yet (ROADMAP Queue 1)."""
