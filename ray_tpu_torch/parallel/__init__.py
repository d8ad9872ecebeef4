"""Parallelism for the port, over a torch DeviceMesh (``mesh``): the mesh
and its logical sharding rules, ring attention and Ulysses over ``sp``, the
GPipe pipeline over ``pp``, the mixture-of-experts layer with its experts
over ``ep`` (``moe``), and ``multichip``'s pool of rank processes and
sharded-step dryrun."""
