"""The simulation quality study's tools, run as modules: ``generate_synthetic``,
``diagnose_quality``, ``eval_saved_volumes``, ``select_checkpoint`` (numpy,
on the host) and the study driver ``run_quality_study``."""
