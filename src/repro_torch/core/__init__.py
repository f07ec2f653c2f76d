"""The port's copy of the COMET core.  So far only what the overlap bench
and its fit need: ``hardware`` (the ``Arch`` family and its presets),
``collectives`` (the Eq. 3/4 collective models) and ``numerics``.  The
cost model, IR, search and plan path come with ROADMAP Queue A.2."""
