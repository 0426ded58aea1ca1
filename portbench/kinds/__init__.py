"""One load generator per kind of traffic: ``run`` steps one board for the whole
window, ``serve`` sends step requests to a session manager from
closed-loop clients.  A traffic file names its kind."""
