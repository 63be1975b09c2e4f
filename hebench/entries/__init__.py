"""Drivers of the program's public entries, one module an entry, found by
the name a mix gives (``"entry"``).  Each defines ``galois_steps(p)`` and
``Driver(sess, p, inputs)`` with ``units`` (operations a call),
``min_calls``, ``warm()``, ``call(i, span)``, ``answers()`` and
``checks()``; its plain math is ``hebench.reference.<entry>``."""
