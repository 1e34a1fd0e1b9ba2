/* exercises the full _NN accessor surface against the port's C library
 * (the port's copy of native/apitest.c, asserting the port's capability
 * bits).  Run it in a directory holding samples/s00. */
#include <libhpnn.h>
#include <assert.h>

int main(void)
{
    nn_def conf;
    CHAR *s = NULL;
    UINT u; SHORT v; nn_type ty; nn_train tr; BOOL b;
    UINT hid[2] = {4, 5};
    FILE *fp;
    DOUBLE *in = NULL, *out = NULL;

    assert(_NN(init,all)(0) == 0);
    _NN(set,verbose)(1);
    _NN(get,verbose)(&v); assert(v == 1);
    _NN(inc,verbose)(); assert(_NN(return,verbose)() == 2);
    _NN(dec,verbose)(); _NN(set,verbose)(0);
    assert(_NN(return,capabilities)() & NN_CAP_TORCH);
    assert(_NN(return,capabilities)() & NN_CAP_X64);
    { nn_cap cap; _NN(get,capabilities)(&cap); assert(cap & NN_CAP_TORCH); }
    assert(_NN(init,OMP)() && _NN(init,MPI)());
    assert(_NN(init,CUDA)() && _NN(init,BLAS)());
    _NN(set,omp_threads)(3);
    _NN(get,omp_threads)(&u); assert(u == 3);
    assert(_NN(return,omp_threads)() == 3);
    _NN(set,omp_blas)(2); _NN(get,omp_blas)(&u); assert(u == 2);
    _NN(set,cuda_streams)(4); _NN(get,cuda_streams)(&u); assert(u == 4);
    _NN(get,mpi_tasks)(&u); assert(u >= 1);
    _NN(get,curr_mpi_task)(&u); assert(u == 0);
    assert(_NN(return,cudas)() != NULL);
    assert(_NN(return,cudas)()->mem_model == CUDAS_MEM_P2P);

    /* C-initialized conf, built through setters, then generate+train */
    _NN(init,conf)(&conf);
    _NN(set,name)(&conf, "apitest");
    _NN(get,name)(&conf, &s); assert(s && !strcmp(s, "apitest")); FREE(s);
    assert(!strcmp(_NN(return,name)(&conf), "apitest"));
    _NN(set,type)(&conf, NN_TYPE_ANN);
    _NN(get,type)(&conf, &ty); assert(ty == NN_TYPE_ANN);
    assert(_NN(return,type)(&conf) == NN_TYPE_ANN);
    _NN(set,need_init)(&conf, TRUE);
    _NN(get,need_init)(&conf, &b); assert(b);
    assert(_NN(return,need_init)(&conf));
    _NN(set,seed)(&conf, 4242);
    _NN(get,seed)(&conf, &u); assert(u == 4242);
    assert(_NN(return,seed)(&conf) == 4242);
    _NN(set,train)(&conf, NN_TRAIN_BP);
    _NN(get,train)(&conf, &tr); assert(tr == NN_TRAIN_BP);
    assert(_NN(return,train)(&conf) == NN_TRAIN_BP);
    _NN(set,samples_directory)(&conf, "./samples");
    _NN(get,samples_directory)(&conf, &s);
    assert(s && !strcmp(s, "./samples")); FREE(s);
    assert(!strcmp(_NN(return,samples_directory)(&conf), "./samples"));
    _NN(set,tests_directory)(&conf, "./tests");
    assert(!strcmp(_NN(return,tests_directory)(&conf), "./tests"));

    assert(conf.kernel == NULL);
    assert(_NN(generate,kernel)(&conf, (UINT)6, (UINT)2, (UINT)3, hid));
    assert(conf.kernel != NULL);
    assert(_NN(get,n_inputs)(&conf) == 6);
    assert(_NN(get,n_hiddens)(&conf) == 2);
    assert(_NN(get,n_outputs)(&conf) == 3);
    assert(_NN(get,h_neurons)(&conf, 0) == 4);
    assert(_NN(get,h_neurons)(&conf, 1) == 5);
    assert(_NN(get,h_neurons)(&conf, 9) == 0);

    fp = fopen("apitest.kernel", "w");
    assert(fp); _NN(dump,kernel)(&conf, fp); fclose(fp);
    fp = fopen("apitest.conf.out", "w");
    assert(fp); _NN(dump,conf)(&conf, fp); fclose(fp);

    /* pointer stability: the reference returns internal pointers that
     * stay valid across training (libhpnn.c:580); the shim must not
     * reallocate unchanged mirror strings during sync */
    {
        char *stable = _NN(return,name)(&conf);
        assert(_NN(train,kernel)(&conf));
        assert(_NN(return,name)(&conf) == stable);
        assert(!strcmp(stable, "apitest"));
    }
    _NN(free,kernel)(&conf);
    assert(conf.kernel == NULL);

    /* reload the dumped kernel through the f_kernel path */
    _NN(set,need_init)(&conf, FALSE);
    _NN(set,kernel_filename)(&conf, "apitest.kernel");
    _NN(get,kernel_filename)(&conf, &s);
    assert(s && !strcmp(s, "apitest.kernel")); FREE(s);
    assert(_NN(load,kernel)(&conf));
    assert(conf.kernel != NULL);
    assert(_NN(get,n_inputs)(&conf) == 6);
    _NN(run,kernel)(&conf);

    /* sample I/O */
    assert(_NN(read,sample)("samples/s00", &in, &out));
    assert(in != NULL && out != NULL);
    assert(out[0] == 1.0 || out[0] == -1.0);
    FREE(in); FREE(out);

    _NN(deinit,conf)(&conf);
    assert(conf.name == NULL && conf.kernel == NULL);
    /* unset masks the STORED runtime capability; get/return recompute
     * from the live backend, exactly like the reference where they
     * re-derive the compile-time bits (libhpnn.c:113-159) */
    _NN(unset,capability)(NN_CAP_X64);
    assert(_NN(return,capabilities)() & NN_CAP_TORCH);
    assert(_NN(deinit,OMP)() && _NN(deinit,MPI)());
    assert(_NN(deinit,all)() == 0);
    printf("APITEST PASS\n");
    return 0;
}
