"""The loops that drive a cell's window, one module each.

A traffic mix is a data file, ``traffic/<mix>.json``, whose ``loop`` key
names one of these modules. A module gives:

- ``KIND``: what the cell measures ("serve" or "train"), which picks its
  checks and the per-layer metrics named ``<metric>.<KIND>``;
- ``PARAMS``: the keys of a traffic file that it reads. A traffic file
  holds these keys, ``loop`` and ``why``, and nothing else, so that no
  setting in it goes unread;
- ``run(cell, seed, seconds, trace, device, t_start)``: set-up, the
  window, the traced slice and the numbers compared (see
  ``harness.measure``).

A new mix that an existing loop can drive is a data file alone; a new kind
of traffic (open-loop arrivals, the Trainer's loader) is a module of its
own here, with no edit of the harness.
"""
