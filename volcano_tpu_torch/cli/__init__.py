"""The port's daemon entry points: ``python -m volcano_tpu_torch.cli``.

``scheduler`` runs the port's scheduler daemon against an apiserver of
either package (``cli/daemons.py`` ``run_scheduler``); ``apiserver`` runs
the port's apiserver (``store/server.py`` ``run_apiserver``).  The JAX
package's other subcommands exit non-zero naming the ROADMAP item they
come with.
"""
