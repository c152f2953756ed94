"""Per-method, per-dataset recommended hyperparameters.

The port's own copy of the ``gcond`` table of
``graphslim_tpu/method_configs.py`` (the reference's JSON config tree,
``graphslim/configs/<method>/<dataset>.json``).  Tables of methods and
datasets that are not ported yet are left out with them.
"""

METHOD_CONFIGS = \
{'gcond': {'cora': {'condense_model': 'SGC',
                    'dis_metric': 'ours',
                    'inner_loop': 15,
                    'lr_adj': 0.0001,
                    'lr_feat': 0.0001,
                    'ntrans': 1,
                    'outer_loop': 20,
                    'pre_norm': True,
                    'threshold': 0.05},
           'ogbn-arxiv': {'condense_model': 'SGC',
                          'dis_metric': 'ours',
                          'epochs': 600,
                          'inner_loop': 3,
                          'lr_adj': 0.01,
                          'lr_feat': 0.01,
                          'ntrans': 2,
                          'outer_loop': 20,
                          'threshold': 0.01}}}
