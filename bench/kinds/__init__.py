"""Traffic kinds: ``bench/kinds/<kind>.py`` for a mix whose file
(``bench/traffic/<mix>.json``) says ``"kind": "<kind>"``. A kind is the
shape of request and the loop that serves it: it makes the mix's inputs on
the device from ``--seed``, drives the program that the configuration's
family adapter (``bench/families/<family>.py``) builds, and judges what the
timed path produced. A mix of a new kind comes as a new kind file beside
its data file; no existing file changes.

Each kind holds a ``Session(family, config, mix, check, seed, device)``
whose constructor is the set-up (weights and inputs drawn on ``device``
from ``seed``, the program built, every shape of the mix warmed up) and
which has:

* ``device``; ``setup_phases``, seconds by phase of the set-up;
* ``cover_steps``, the steps that serve every input of the mix once (the
  control's short window);
* ``step(i)``, one step of the closed loop, returning the record of the
  batch it finished, or None: ``items`` (what the cell counts),
  ``latency_ms``, and what the metric readers of the kind's cells read;
* ``drain()``, the records of the batches still in flight, finished;
* ``window_done(steps, elapsed, seconds)``, whether the window may close;
* ``free_program()``, dropping the program's state before the check;
* ``compared(products="float32")``, the numbers the check compares, and,
  with a lower precision's name, the control's.
"""
