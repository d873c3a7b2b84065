"""One driver a traffic kind: ``Cell(config, mix, seed, device)`` builds the
system under test and warms up the cell's shapes; ``window(seconds,
traced)`` runs the traffic and returns ``{"units", "metrics"}``;
``check()`` frees the program's state and returns the numbers the
correctness comparison reads, by the names of the mix's ``limits``;
``reference_s``: the seconds set-up spent in the reference."""
