"""Family adapters: ``bench/families/<family>.py`` for a configuration whose
file says ``"family": "<family>"``. An adapter knows one model of the port
and nothing of the traffic; it holds:

* ``prepare(config)``, the configuration with the sizes the program derives
  from it (such as the width of an interaction) added;
* ``make_weights(config, seed, device)``, the benchmark's weights drawn on
  ``device`` from ``seed``, in a few large calls, named as the program's;
* ``build(config, weights)``, the program under test on those weights;
* the plain reference's entry points that the traffic kinds of the
  family's cells call (``bench/kinds/<kind>.py`` says which).
"""
