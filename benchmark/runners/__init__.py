"""General runners, one for each kind of job; a traffic mix's file names
the runner that reads it.  Each runner's ``run(job)`` sets up from the
seed, warms the cell's shapes, measures inside ``job.window()``, judges
what the window produced against the plain reference, and returns a
``harness.Outcome``; its ``controls(job)`` yields the control's readings
(``tools/readings.py``)."""
