"""The benchmark of ``gpu_stereo_matching_tpu_torch`` on one card.

``run.py`` runs one cell of ``BENCHMARK.json``. Each part is found by its
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``systems/<system>.py`` (the program's entry and its plain reference, which
lives in ``reference/``) and ``metrics/<metric>.py`` (a reader). The
yardstick (``scene.py``, ``window.py``, ``trace.py``, ``roofline.py``, the
reference) lives here, apart from the program.
"""
