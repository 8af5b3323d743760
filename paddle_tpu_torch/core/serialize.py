"""Program <-> dict serialization (reference: paddle_tpu
core/serialize.py; the reference framework's ProgramDesc protobuf).

The same JSON keys as the JAX package, so a Program serialized by either
package loads into the other, each op with its provenance.
"""

from .program import Block, Parameter, Program, Variable


def _var_to_dict(v):
    return {
        'name': v.name,
        'shape': list(v.shape) if v.shape is not None else None,
        'dtype': v.dtype,
        'lod_level': v.lod_level,
        'persistable': v.persistable,
        'stop_gradient': v.stop_gradient,
        'is_data': v.is_data,
        'is_parameter': isinstance(v, Parameter),
        'trainable': v.trainable,
    }


def program_to_dict(program):
    blocks = []
    for b in program.blocks:
        blocks.append({
            'idx': b.idx,
            'parent_idx': b.parent_idx,
            'vars': [_var_to_dict(v) for v in b.vars.values()],
            'ops': [{'type': op.type, 'inputs': op.inputs,
                     'outputs': op.outputs, 'attrs': op.attrs,
                     'provenance': op.provenance}
                    for op in b.ops],
        })
    return {'blocks': blocks, 'random_seed': program.random_seed}


def program_from_dict(data):
    p = Program()
    p.random_seed = data.get('random_seed')
    for i, bd in enumerate(data['blocks']):
        if i == 0:
            b = p.global_block()
        else:
            b = Block(p, i, bd['parent_idx'])
            p.blocks.append(b)
        for vd in bd['vars']:
            shape = tuple(vd['shape']) if vd['shape'] is not None else None
            if vd['is_parameter']:
                v = Parameter(b, vd['name'], shape, vd['dtype'],
                              trainable=vd['trainable'])
            else:
                v = Variable(b, vd['name'], shape=shape, dtype=vd['dtype'],
                             lod_level=vd['lod_level'],
                             persistable=vd['persistable'],
                             is_data=vd['is_data'])
            v.stop_gradient = vd['stop_gradient']
            b.vars[vd['name']] = v
        for od in bd['ops']:
            # the recorded construction site (absent from dicts written
            # without one), not this call's
            b.append_op(od['type'], od['inputs'], od['outputs'],
                        od['attrs']).provenance = od.get('provenance')
    p.current_block_idx = 0
    return p
