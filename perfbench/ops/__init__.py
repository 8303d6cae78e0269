"""One module an operation the window drives, found by the traffic's
``op``: ``<op>.py`` holds

- ``make_call(col, spec, pool)``: a function of the call's index ``i``
  that sends the ``i``-th batch of the pool and returns ``(pool rows,
  hits)``, the hits as the program returns them (a list a query of dicts
  with ``id`` and ``score``);
- ``reference(cfg, traffic, ds, pool, mask, dtype)``: the plain
  reference's answers to every pool query (:class:`perfbench.judge.Reference`
  with ``rows [P, k]`` and ``scores``);
- ``numbers(cfg, traffic, ds, pool, ref, hits)``: the numbers compared that
  the operation adds to those every operation has;
- optionally ``side_calls(col, spec, pool, sync)``: named calls that the
  traced run times alone, before it profiles (``run.side_s[name]``).
"""
