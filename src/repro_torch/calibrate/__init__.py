"""The port's calibration loop.  So far only what the overlap bench needs:
``overlap`` (``fit_overlap`` and its synthetic sweep) and the two names of
``harness`` it uses.  The sweep's measure functions, the NoC fitter,
``persist`` and ``calibrate_once`` come with ROADMAP Queue A.6."""
