"""One reader a metric, found by the metric's name: ``<name>.py`` holds
``read(run)``, which returns the number from the run's record
(:class:`perfbench.harness.Run`), or ``None`` when the run holds nothing
for it to read (the metric is then left out of the result)."""
