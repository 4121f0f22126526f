"""The sequential numpy oracle (copy of ``cgx_tpu/oracle/``): the spec the
pipeline is held to, run by ``cli --engine oracle`` on the host."""
