"""The checks of one volume estimator, one module an estimator, found by
the name a configuration gives under its "check" key
(gbench/checks/<check>.py). Each module defines:

  TARGETS                      {kind: (module of gvpm_tpu_torch, function)}:
                               the program's calls this estimator records
                               beyond the shared ones (capture.SHARED)
  expected_calls(cell, me_calls)
                               {kind: calls a pass}: its share of
                               stage_calls (me_calls: the shared ME
                               chain walks and shifts, {kind: count})
  numbers(log, sc, cell, seed, it, light, control=None)
                               {name: number}: its stage numbers from the
                               recorded pass `log`, the reference scene
                               `sc`, the light records of every rank
                               `light` (None where none was recorded) and,
                               for the control, the scene in a lower
                               precision whose reference takes the
                               program's place; each number reads
                               check.MISSING where its stage was not
                               recorded.

What every estimator shares (the light and camera passes, the photon
gathers' kernels and tables, ME, the film, the solve, repeat_err and
stage_calls) is in gbench/check.py.
"""
