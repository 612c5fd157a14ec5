"""Drivers: the system a configuration runs, found by the configuration's
``driver`` key (``drivers/<driver>.py``).  A driver module gives:

* ``inputs(config, mix, seed)``: the run's inputs from the seed, with
  ``warmup_steps`` and ``step(i)`` (what step ``i`` renders or computes);
* ``require()``, which fails where the program is absent, and
  ``make(config, backend, seed)``: the system under test;
* ``Client(system, inputs, config)``: ``step(i)`` runs step ``i`` and
  returns its finished output, ``problem(output)`` says why an output is
  malformed (None when it is not), ``phases(log)`` is a context in which
  steps record their phase times, read by ``phase_times()``;
* ``NUMBERS`` and ``numbers(inputs, config, seed, kept, device=,
  control=)``: the comparison with the driver's plain reference over the
  kept ``(step, output)`` pairs, each number held to
  ``config["check"]["limits"]``; with ``control`` (a dtype) the reference
  in that precision takes the program's place;
* ``FAULTS``: name -> ``(config, backend, seed) -> system``, the timed
  path broken underneath as the tests and ``control.py`` plant it.
"""
