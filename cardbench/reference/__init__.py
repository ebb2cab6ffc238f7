"""The plain reference of each configuration's block, one module a block
(named by the configuration file's ``reference``), with the parts they
share in ``common``."""
